"""Auxiliary subsystems of the port: profiling hooks
(:mod:`socceraction_tpu_torch.utils.profiling`)."""

from .profiling import Timer, annotate, profile_trace, record_value, timed, timer_report

__all__ = ['Timer', 'annotate', 'profile_trace', 'record_value', 'timed', 'timer_report']
