"""Cross-view fusion (port of ``skix/fuse``)."""
