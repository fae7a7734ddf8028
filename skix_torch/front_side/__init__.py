"""Front-camera bird's-eye view (a numpy copy of ``skix/front_side``)."""
