"""Multi-encode drivers of the port (counterpart of the reference's
parallel/): so far the ABR ladder."""
