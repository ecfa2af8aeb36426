"""Host-side helpers of the port: ``flops`` (the MFU arithmetic)."""
