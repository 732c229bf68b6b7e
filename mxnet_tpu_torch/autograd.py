"""Autograd scopes.

Counterpart of ``mxnet_tpu/autograd.py``.  This slice serves inference
only, so ``record`` and ``pause`` keep the two flags (recording,
training) and their nesting, and nothing is taped.  A Block runs its
forward with torch's gradient mode set to ``is_recording()``; a kernel
with no backward yet (the flash-attention forward) raises if a gradient
is asked through it.  The tape, ``backward`` and ``Function`` come with
the training slice (ROADMAP Queue 1, slice 2).
"""
from __future__ import annotations

import threading


class _AGState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _AGState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._rec, self._train = is_record, train_mode
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        if self._rec is not None:
            _STATE.recording = self._rec
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev


def record(train_mode: bool = True):
    """``with autograd.record():`` — turn on recording (+training mode)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """``with autograd.pause():`` — suspend recording."""
    return _RecordingStateScope(False, train_mode)

