"""socceraction on PyTorch and CUDA: the port of ``socceraction_tpu``.

The JAX package (``socceraction_tpu``) is the reference this package is
held against; the port imports nothing from it and keeps its own copy of
every constant it needs. Entry points (:class:`~.vaep.base.VAEP`,
:func:`~.vaep.base.load_model`, :class:`~.xthreat.ExpectedThreat`,
:func:`~.xthreat.load_model`, :func:`~.core.synthetic.synthetic_batch`,
:func:`~.core.batch.pack_actions`, :func:`~.convert.mlp_from_jax_params`)
run on ``cuda`` unless the caller passes ``device='cpu'``, and raise when
no GPU is present and the CPU was not asked for.

Ported so far: VAEP serving (``VAEP.rate_batch`` on the fused fold), with
the fused gather + matmul first layer as a hand-written CUDA kernel
(``csrc/gather_matmul.cu``); and xT (``xthreat.ExpectedThreat``, dense and
matrix-free, single grids and fleets), with the segment sum under every
count and matrix-free sweep as a hand-written CUDA kernel
(``csrc/segment_sum.cu``).
"""
