"""SAM3 front path of the port: detector, memory tracker, masklet
lifecycle and the session API (port of ``skix/tracking``)."""
