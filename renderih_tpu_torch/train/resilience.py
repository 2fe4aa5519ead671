"""Step-level failure recovery for the training loop (counterpart of
`renderih_tpu/train/resilience.py`).

`run_step_guarded` runs one step and
  * retries a transient failure with exponential backoff: by default a
    CUDA out-of-memory error, after emptying the allocator's cache. Only
    a failure before the update qualifies: the train step then restores
    the BatchNorm statistics, so the state it leaves is the one it was
    given;
  * on any other failure (or retries exhausted) saves a `crash`
    checkpoint of the state and re-raises; `--resume auto` picks it up;
  * on a failure inside the update (`UpdateFailed`: the optimizer or
    EMA may have written part of it) saves nothing and re-raises: the
    state is neither the old one nor the new one, and the newest
    `epoch_N` checkpoint is where to resume.
"""

from __future__ import annotations

import logging
import os
import time

import torch

log = logging.getLogger("renderih_tpu_torch.resilience")


class UpdateFailed(RuntimeError):
    """A train step failed after its update began; raised from the cause."""


def is_transient(err: BaseException) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError)


def run_step_guarded(step_thunk, state, checkpoint_dir: str, *, retries: int = 3,
                     backoff_s: float = 10.0, save_fn=None, sleep=time.sleep):
    """`step_thunk()` (one step on `state`) with retries of transient
    failures and a crash save of `state` before anything else re-raises."""
    if save_fn is None:
        from renderih_tpu_torch.train.state import save_checkpoint as save_fn

    attempt = 0
    while True:
        try:
            return step_thunk()
        except Exception as err:  # classified below; re-raised unless retried
            if isinstance(err, UpdateFailed):
                log.error("the step failed inside its update; no crash checkpoint "
                          "(resume from the newest epoch checkpoint): %s", err.__cause__)
                raise
            if is_transient(err) and attempt < retries:
                attempt += 1
                wait = backoff_s * 2 ** (attempt - 1)
                log.warning("transient step failure (attempt %d/%d, retry in %.0fs): %s",
                            attempt, retries, wait, err)
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                sleep(wait)
                continue
            path = os.path.abspath(os.path.join(checkpoint_dir, "crash"))
            try:
                save_fn(path, state)
                log.error("saved crash checkpoint %s (resume with --resume auto)", path)
            except Exception as save_err:  # the step's error is the one to raise
                log.error("crash checkpoint failed: %s", save_err)
            raise
