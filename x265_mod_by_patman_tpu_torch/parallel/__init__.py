"""Multi-encode drivers of the port (counterpart of the reference's
parallel/): the ABR ladder, multi-stream encoding on one device, and
GOP-parallel chunked encoding with its elastic scheduler."""
