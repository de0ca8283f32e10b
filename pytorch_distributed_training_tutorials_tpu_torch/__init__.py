"""PyTorch/CUDA port of ``pytorch_distributed_training_tutorials_tpu``.

The JAX package beside this one is the reference; this package restates
it in PyTorch for an NVIDIA H100 (``sm_90a``). Every kernel
the JAX package wrote in Pallas for the TPU becomes a kernel written by
hand for Hopper, with a plain PyTorch version beside it that the CPU runs.

Covered so far: int8 and paged serving (:mod:`.serve`, ``ServeEngine``),
the LM train step with its fused tail (:mod:`.train`,
:mod:`.bench.lm_headline`), the nine kernels (:mod:`.ops`), and the DDP
training main path — :mod:`.data`, the ResNets and MLPs of
:mod:`.models`, :mod:`.parallel` on ``torch.distributed``, the
``Trainer`` and :mod:`.launch`. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

This package imports ``torch``, numpy and the standard library only —
never ``jax`` and nothing of the JAX package (``tests/test_torch_no_jax.py``
holds it to that).
"""
