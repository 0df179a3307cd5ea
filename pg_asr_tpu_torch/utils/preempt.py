"""Preemption-safe runs (counterpart of pg_asr_tpu/utils/preempt.py):
SIGTERM (the standard cloud-preemption signal) sets an event that the loop
polls once per step, so that it can save model_last at the exact step and
return instead of dying mid-step. Policy-gradient fine-tuning
(``rl/reinforce.finetune_pg``) polls it; rerunning resumes from that save.
"""

from __future__ import annotations

import os
import signal
import threading


def install_preemption_handler():
    """Install a SIGTERM handler that sets an event instead of terminating.

    Returns (event, restore):
      event: threading.Event set when SIGTERM arrives (poll it per step);
      restore(): reinstate the previous handler — call on every exit path.

    A second SIGTERM after the first terminates immediately (restores the
    previous or default disposition and re-raises), so a stuck save cannot
    make the process unkillable. No-op (the event is never set, restore
    does nothing) when not on the main thread: Python allows signal handlers
    only there.
    """
    event = threading.Event()
    if threading.current_thread() is not threading.main_thread():
        return event, lambda: None

    prev = signal.getsignal(signal.SIGTERM)

    def on_sigterm(signum, frame):
        if event.is_set():  # second SIGTERM: give up and terminate
            signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        event.set()

    try:
        signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # a non-main interpreter thread raced us
        return event, lambda: None

    def restore():
        try:
            if signal.getsignal(signal.SIGTERM) is on_sigterm:
                signal.signal(signal.SIGTERM, prev)
        except ValueError:
            pass

    return event, restore
