"""socceraction on PyTorch and CUDA: the port of ``socceraction_tpu``.

The JAX package (``socceraction_tpu``) is the reference this package is
held against; the port imports nothing from it and keeps its own copy of
every constant it needs. Entry points (:class:`~.vaep.base.VAEP`,
:func:`~.vaep.base.load_model`, :class:`~.xthreat.ExpectedThreat`,
:func:`~.xthreat.load_model`, :func:`~.core.synthetic.synthetic_batch`,
:func:`~.core.batch.pack_actions`, :func:`~.convert.mlp_from_jax_params`,
:class:`~.atomic.vaep.base.AtomicVAEP`, :class:`~.seq.classifier.SeqClassifier`)
run on ``cuda`` unless the caller passes ``device='cpu'``, and raise when
no GPU is present and the CPU was not asked for.

Ported so far: VAEP serving (``VAEP.rate_batch`` on the fused fold) and
training (``VAEP.fit_packed``, both MLP heads with Adam on the fused
fold, ``save_model`` in the JAX package's checkpoint format), with the
fused gather + matmul first layer as a hand-written CUDA kernel
(``csrc/gather_matmul.cu``) in serving and in every training step; the
same for Atomic-VAEP (:class:`~.atomic.vaep.base.AtomicVAEP`); the GRU
sequence head (``fit_packed(learner='seq')``, :mod:`.seq`) for both; and
xT (``xthreat.ExpectedThreat``, dense and matrix-free, single grids and
fleets), with the segment sum under every count, matrix-free sweep and
training statistics pass as a hand-written CUDA kernel
(``csrc/segment_sum.cu``).
"""
