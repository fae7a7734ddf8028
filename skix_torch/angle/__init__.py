"""Joint-angle biomechanics and turn segmentation (port of ``skix/angle``)."""
