"""The benchmark's frozen counts: the card's peaks, the work a layer needs.

The counts are of the work the inputs need, whatever computes it, so that a
later change to the program cannot move them:

- B1, the fused gather + dense first layer of both heads side by side,
  over ``rows`` valid actions (padding rows and bucket fill count for
  nothing): every input read once (the ``k`` combined tables ``(R, H)``,
  the dense weight ``(D, H)`` and the bias, the ``(rows, k)`` int32 ids and
  the ``(rows, D)`` float32 dense block) and the ``(rows, H)`` float32
  output written once; ``2·rows·D·H`` operations of the dense product plus
  one add per gathered element (``rows·k·H``).
- The model's FLOPs per valid action: the count of the configuration's
  head kind (``flops_per_action`` of ``cardbench/heads/<head>.py``; for
  MLP heads B1's operations, then each head's hidden chain).

Operations are divided by the dense TF32 tensor-core rate, the fastest rate
at which this card multiplies float32 operands within the parity contract,
so no later implementation can push a share past 100%. The same counts as
the port's ``ops/gather_matmul.py:first_layer_cost``, without its 3x of
3xTF32 (a choice of the implementation, not work the inputs need).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

#: Published peaks of the H100 SXM part (NVIDIA H100 Tensor Core GPU
#: datasheet, dense rates, at its 700 W limit), keyed by the prefix of
#: ``torch.cuda.get_device_name()``: HBM bytes/s, float32 FLOP/s outside the
#: tensor cores, dense TF32 FLOP/s on them.
PEAKS: Dict[str, Dict[str, float]] = {
    'NVIDIA H100 80GB HBM3': {'bytes_per_s': 3.35e12, 'flops_f32': 67e12, 'flops_tf32': 495e12},
}
#: B1's kernel, as its name appears in a device trace.
B1_KERNEL = 'gather_matmul_kernel'


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by its name, or ``None`` for a card not listed."""
    for prefix, row in PEAKS.items():
        if device_name.startswith(prefix):
            return row
    return None


def b1_shape(config: Dict[str, Any]) -> Dict[str, int]:
    """B1's ``k``, ``R``, ``H``, ``D`` for a configuration: both heads' first
    layers side by side (``H = 2·hidden[0]``)."""
    return {'k': config['nb_prev_actions'], 'r': config['table_rows'],
            'h': 2 * config['hidden'][0], 'd': config['dense_columns']}


def b1_bytes(config: Dict[str, Any], rows: int) -> float:
    s = b1_shape(config)
    k, r, h, d = s['k'], s['r'], s['h'], s['d']
    return float(4 * (k * r * h + d * h + h) + rows * 4 * (k + d + h))


def b1_ops(config: Dict[str, Any], rows: int) -> float:
    s = b1_shape(config)
    return float(rows * (2 * s['d'] * s['h'] + s['k'] * s['h']))


def b1_least_seconds(config: Dict[str, Any], rows: int, peak: Dict[str, float]) -> float:
    """The least time the card needs for B1 on ``rows`` valid actions."""
    return max(b1_bytes(config, rows) / peak['bytes_per_s'],
               b1_ops(config, rows) / peak['flops_tf32'])


def flops_per_action(config: Dict[str, Any], head: Any) -> float:
    """The model's FLOPs for one valid action rated, as ``head``, the
    configuration's head module (``cardbench/heads/<head>.py``), counts
    them."""
    return float(head.flops_per_action(config))
