"""Host-side visualization: masklet overlays and the 3D BEV renderer."""
