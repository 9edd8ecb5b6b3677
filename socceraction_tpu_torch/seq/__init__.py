"""The GRU sequence head: a second head architecture behind the VAEP
probability interface (port of ``socceraction_tpu/seq``). Train it through
``VAEP.fit_packed(learner='seq')``."""

from .classifier import SEQ_FORMAT_VERSION, SeqClassifier
from .model import (
    SeqModule,
    dense_stats,
    init_seq_params,
    seq_logits,
    seq_pair_probs,
    seq_param_shapes,
    seq_train_logits,
)

__all__ = [
    'SEQ_FORMAT_VERSION',
    'SeqClassifier',
    'SeqModule',
    'dense_stats',
    'init_seq_params',
    'seq_logits',
    'seq_pair_probs',
    'seq_param_shapes',
    'seq_train_logits',
]
