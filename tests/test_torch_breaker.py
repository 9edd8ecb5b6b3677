"""The port's circuit breaker against the JAX package's, and the port's one
error type for a kernel that cannot run.

The four breaker schedules of ``tests/test_resil.py`` run through both
packages' ``CircuitBreaker`` on injected clocks; at every step the two
must agree exactly: the verdicts, states, trips, the returned trip flags,
``to_dict()``, and the ``resil/breaker_state`` gauge and
``resil/breaker_trips`` / ``resil/breaker_probes`` counter deltas in each
package's own metric registry.

``KernelError`` (``ops/cuda_build.py``) is raised at every site where a
hand-written kernel cannot run: no toolkit, a compiler that does not
start, a failed ``nvcc`` build, a library that does not load, and B1's
and B2's launches (and B2's launch plan) returning a ``cudaError_t``;
any other exception on a wrapper's CUDA side becomes one too
(``kernel_boundary``). The wrappers' refusals (a device with no kernel,
B1's shared-memory refusal of a model's widths) raise its subclass
``KernelRefused`` (a ``ValueError`` too).
Each site is driven on the CPU with its toolkit lookup or its library
entry patched; ``KernelError`` is a ``RuntimeError``, so every existing
``pytest.raises(RuntimeError)`` over those sites still holds.
"""

import contextlib
import sys
from types import SimpleNamespace

import pytest
import torch

from socceraction_tpu.obs import REGISTRY as JAX_REGISTRY
from socceraction_tpu.resil import CircuitBreaker as JaxBreaker
from socceraction_tpu_torch.obs import REGISTRY
from socceraction_tpu_torch.ops import cuda_build
from socceraction_tpu_torch.ops import gather_matmul as gm
from socceraction_tpu_torch.ops import segment as seg
from socceraction_tpu_torch.ops.cuda_build import KernelError, KernelRefused
from socceraction_tpu_torch.resil import CircuitBreaker

PKGS = {
    'jax': SimpleNamespace(Breaker=JaxBreaker, metrics=JAX_REGISTRY),
    'port': SimpleNamespace(Breaker=CircuitBreaker, metrics=REGISTRY),
}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _Recorder:
    """Every observation of one schedule, with the package's metric deltas."""

    def __init__(self, p, breaker):
        self.p, self.b, self.seen = p, breaker, []
        self.base = self._metrics()

    def _metrics(self):
        snap = self.p.metrics.snapshot()
        return (
            snap.value('resil/breaker_trips'),
            snap.value('resil/breaker_probes', outcome='closed'),
            snap.value('resil/breaker_probes', outcome='reopened'),
        )

    def note(self, label, value=None):
        snap = self.p.metrics.snapshot()
        deltas = tuple(a - b for a, b in zip(self._metrics(), self.base))
        self.seen.append((
            label, value, self.b.state, self.b.trips, self.b.to_dict(),
            snap.value('resil/breaker_state', stat='last'), deltas,
        ))
        return value


def _trip_halfopen_close(p):
    clock = _Clock()
    b = p.Breaker(failure_threshold=3, recovery_time_s=5.0, name='t.path', clock=clock)
    r = _Recorder(p, b)
    r.note('allow', b.allow())
    r.note('fail', b.record_failure(RuntimeError('x')))
    r.note('fail', b.record_failure(RuntimeError('x')))
    r.note('fail', b.record_failure(RuntimeError('third')))
    r.note('allow', b.allow())
    for t in (4.9, 5.1):
        clock.t = t
        r.note(f'allow@{t}', b.allow())
    r.note('allow', b.allow())
    r.note('success', b.record_success())
    r.note('allow', b.allow())
    return r.seen


def _probe_failure_reopens(p):
    clock = _Clock()
    b = p.Breaker(failure_threshold=1, recovery_time_s=2.0, name='t.path2', clock=clock)
    r = _Recorder(p, b)
    r.note('fail', b.record_failure(RuntimeError('boom')))
    clock.t = 2.5
    r.note('allow', b.allow())
    r.note('fail', b.record_failure(RuntimeError('still down')))
    for t in (4.0, 4.6):
        clock.t = t
        r.note(f'allow@{t}', b.allow())
    r.note('success', b.record_success())
    return r.seen


def _success_resets_streak(p):
    b = p.Breaker(failure_threshold=3, name='t.path3', clock=_Clock())
    r = _Recorder(p, b)
    for step in ('fail', 'fail', 'success', 'fail', 'fail'):
        r.note(step, b.record_failure() if step == 'fail' else b.record_success())
    return r.seen


def _validation(p):
    try:
        p.Breaker(failure_threshold=0)
    except ValueError as e:
        return ('ValueError', str(e))
    return None


SCHEDULES = {
    'trip_halfopen_close': _trip_halfopen_close,
    'probe_failure_reopens': _probe_failure_reopens,
    'success_resets_streak': _success_resets_streak,
    'validation': _validation,
}


@pytest.mark.parametrize('schedule', list(SCHEDULES))
def test_breaker_schedules_match_the_jax_package(schedule):
    out = {pkg: SCHEDULES[schedule](p) for pkg, p in PKGS.items()}
    assert out['port'] == out['jax']
    assert out['port'] is not None


def test_trip_schedule_reaches_every_state():
    """The comparison above is not vacuous: the schedule trips, probes and
    closes (the JAX test's assertions, on the port's run)."""
    seen = _trip_halfopen_close(PKGS['port'])
    states = [s[2] for s in seen]
    assert {'closed', 'open', 'half_open'} <= set(states)
    assert seen[3][1] is True and seen[3][3] == 1  # the third failure trips
    assert [s[1] for s in seen[5:8]] == ['open', 'probe', 'open']
    assert seen[-1][4]['last_error'] == 'RuntimeError: third'
    assert seen[-1][6] == (1, 1, 0)


def test_abandoned_probe_frees_the_slot_and_changes_nothing_else():
    """A probe whose call failed for the kernel's own reason (the service's
    KernelError path) gives its slot back unjudged: still half-open, no
    trip, no probe verdict, and the next caller is the new probe."""
    clock = _Clock()
    b = CircuitBreaker(failure_threshold=1, recovery_time_s=1.0, name='t.abandon', clock=clock)
    b.record_failure(RuntimeError('down'))
    clock.t = 2.0
    before = REGISTRY.snapshot()
    assert b.allow() == 'probe'
    assert b.allow() == 'open'
    b._abandon_probe()
    snap = b.to_dict()
    assert (b.state, b.trips, snap['consecutive_failures']) == ('half_open', 1, 1)
    after = REGISTRY.snapshot()
    for outcome in ('closed', 'reopened'):
        assert (after.value('resil/breaker_probes', outcome=outcome)
                == before.value('resil/breaker_probes', outcome=outcome))
    assert b.allow() == 'probe'
    b.record_success()
    assert b.state == 'closed'


# -- KernelError at every site where a kernel cannot run -------------------------------------


def test_kernel_error_is_a_runtime_error():
    assert issubclass(KernelError, RuntimeError)
    with pytest.raises(RuntimeError, match='cannot run'):
        raise KernelError('the kernel cannot run')


def test_no_toolkit_raises_kernel_error(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, 'CUDA_HOME', None)
    with pytest.raises(KernelError, match='no CUDA toolkit'):
        cuda_build._nvcc()


def test_a_failed_build_raises_kernel_error(monkeypatch, tmp_path):
    """The compiler exits non-zero (here: the interpreter, refusing nvcc's
    flags): KernelError with its output, nothing loaded or left behind."""
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path / 'kernels')
    monkeypatch.setattr(cuda_build, '_loaded', {})
    monkeypatch.setattr(cuda_build, '_nvcc', lambda: sys.executable)
    with pytest.raises(KernelError, match='nvcc failed to build') as info:
        cuda_build.load_library('gather_matmul')
    assert isinstance(info.value, RuntimeError)
    assert 'gather_matmul' not in cuda_build._loaded
    assert not list((tmp_path / 'kernels').glob('*.so'))


def test_a_compiler_that_does_not_start_raises_kernel_error(monkeypatch, tmp_path):
    """A toolkit whose ``bin/nvcc`` is missing (a runtime-only CUDA_HOME):
    the ``FileNotFoundError`` arrives as a ``KernelError``."""
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path / 'kernels')
    monkeypatch.setattr(cuda_build, '_loaded', {})
    monkeypatch.setattr(cuda_build, '_nvcc', lambda: str(tmp_path / 'cuda' / 'bin' / 'nvcc'))
    with pytest.raises(KernelError, match='gather_matmul cannot run: FileNotFoundError') as info:
        cuda_build.load_library('gather_matmul')
    assert isinstance(info.value.__cause__, FileNotFoundError)
    assert 'gather_matmul' not in cuda_build._loaded


def test_a_library_that_does_not_load_raises_kernel_error(monkeypatch, tmp_path):
    """The build succeeds but ``dlopen`` refuses what it wrote: the
    ``OSError`` arrives as a ``KernelError``."""
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho not-a-library > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, 'BUILD_DIR', tmp_path / 'kernels')
    monkeypatch.setattr(cuda_build, '_loaded', {})
    monkeypatch.setattr(cuda_build, '_nvcc', lambda: str(fake))
    with pytest.raises(KernelError, match='segment_sum cannot run: OSError') as info:
        cuda_build.load_library('segment_sum')
    assert isinstance(info.value.__cause__, OSError)
    assert 'segment_sum' not in cuda_build._loaded


@pytest.mark.parametrize('error', [OSError('dlopen failed'), AttributeError('no symbol'),
                                   RuntimeError('CUDA error: out of memory')])
def test_kernel_boundary_raises_every_other_error_as_kernel_error(error):
    with pytest.raises(KernelError, match=f'B1 cannot run: {type(error).__name__}') as info:
        with cuda_build.kernel_boundary('B1'):
            raise error
    assert info.value.__cause__ is error
    refused = KernelRefused('needs contiguous operands')
    with pytest.raises(KernelRefused) as info:
        with cuda_build.kernel_boundary('B1'):
            raise refused
    assert info.value is refused


def test_the_wrappers_refuse_a_device_with_no_kernel():
    """Off the CPU and off the card (here the meta device) each wrapper
    refuses with ``KernelRefused``, still a ``ValueError``."""
    meta = torch.device('meta')
    operands = (torch.zeros((2, 4, 8), device=meta), torch.zeros((3, 8), device=meta),
                torch.zeros(8, device=meta), torch.zeros((5, 2), dtype=torch.int32, device=meta),
                torch.zeros((5, 3), device=meta))
    with pytest.raises(KernelRefused, match='no kernel for device meta'):
        gm.fused_first_layer_quant(*operands)
    with pytest.raises(ValueError, match='no kernel for device meta'):
        seg.segment_sum(torch.ones(6, device=meta), torch.zeros(6, dtype=torch.int32,
                                                                device=meta), 3)


def test_b1_launch_error_raises_kernel_error():
    """B1's launch returning a ``cudaError_t`` (700, an illegal address)."""
    tables = torch.zeros((2, 4, 8))
    operands = (tables, torch.zeros((3, 8)), torch.zeros(8),
                torch.zeros((5, 2), dtype=torch.int32), torch.zeros((5, 3)))
    out = torch.empty((5, 8))
    calls = []

    def fails(*args):
        calls.append(args)
        return 700

    before = gm.fused_first_layer_quant.launches
    with pytest.raises(KernelError, match='gather_matmul kernel launch failed: cudaError_t 700'):
        gm._launch(fails, operands, out, (5, 2, 4, 8, 3), 0)
    assert len(calls) == 1 and calls[0][6:11] == (5, 2, 4, 8, 3)
    assert gm.fused_first_layer_quant.launches == before
    assert gm._launch(lambda *args: 0, operands, out, (5, 2, 4, 8, 3), 0) == 0


def test_b1_shared_memory_refusal_raises_kernel_refused():
    """Widths whose block would need more shared memory than Hopper gives
    one: ``KernelRefused``, a ``KernelError`` and a ``ValueError``."""
    lib = SimpleNamespace(gather_matmul_smem_bytes=lambda k, h, d: 232448 + d)
    with pytest.raises(KernelRefused, match='needs 236544 bytes') as info:
        gm._check_smem(lib, 3, 256, 4096)
    assert isinstance(info.value, KernelError) and isinstance(info.value, ValueError)
    gm._check_smem(SimpleNamespace(gather_matmul_smem_bytes=lambda k, h, d: 1024), 3, 256, 55)


def test_b2_launch_error_raises_kernel_error():
    vals, ids, out = torch.ones(6), torch.zeros(6, dtype=torch.int32), torch.empty(3)
    with pytest.raises(KernelError, match='segment_sum kernel launch failed: cudaError_t 719'):
        seg._launch(lambda *args: 719, vals, ids, out, 3, 1, 0, 0)
    seg._launch(lambda *args: 0, vals, ids, out, 3, 1, 0, 0)


def test_b2_launch_plan_error_raises_kernel_error(monkeypatch):
    lib = SimpleNamespace(segment_sum_plan=lambda *args: 98)
    monkeypatch.setattr(cuda_build, 'load_library', lambda name: lib)
    monkeypatch.setattr(torch.cuda, 'device', lambda index: contextlib.nullcontext())
    with pytest.raises(KernelError, match='segment_sum launch plan failed: cudaError_t 98'):
        seg._plan.__wrapped__(0, 10, 4)
