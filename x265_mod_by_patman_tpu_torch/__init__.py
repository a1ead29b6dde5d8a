"""PyTorch + CUDA port of the HEVC encoder, with its CLI (``cli``) and
API (``api``).

The JAX package ``x265_mod_by_patman_tpu`` is the reference; this package
mirrors its layout (``ops/``, ``analysis/``, ``frame/``, ``encoder/``,
``utils/``) and imports nothing of it: the jax-free host modules it needs
(``params``, ``bitstream``, ``entropy``, ``rc``, ``frame.zscan``,
``constants``, ``io``, ``utils.{trace,metrics,vmaf}``, the host half of
``analysis.weightp`` and the native C entropy engine under ``native``)
are copied here verbatim.
The two hand-written Hopper kernels (``ops/cuda``, sources in ``csrc/``)
replace the reference's Pallas SAD-grid and window-gather kernels.  The
entry points run on the card unless the caller asks for "cpu".
"""
