"""Keypoint extraction and point tracks for feed-forward SfM (port of
``skix/perception``)."""
