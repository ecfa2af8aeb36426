"""Host-side helpers of the port: ``flops`` (the MFU arithmetic) and
``tree`` (maps over trees of dicts, lists and tuples of arrays)."""
