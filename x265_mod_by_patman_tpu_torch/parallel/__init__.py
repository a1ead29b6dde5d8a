"""Multi-encode drivers of the port (counterpart of the reference's
parallel/): the ABR ladder, multi-stream encoding on one device,
GOP-parallel chunked encoding with its elastic scheduler, the mesh of
logical shards with its sharded step, and tile-row P analysis."""
