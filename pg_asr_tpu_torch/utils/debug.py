"""Numerical debugging helpers (counterpart of pg_asr_tpu/utils/debug.py),
over the port's flat state dicts (nested dicts are walked too):

  * enable_nan_checks(): the CLI's ``--debug_nans``. Turns on autograd's
    anomaly mode with its NaN check (a backward function that returns NaN
    raises, with the forward's traceback) and ``check_nans``;
  * check_nans(): with the checks on, raises FloatingPointError on a NaN
    and lets +-Inf pass, as the JAX package's ``jax_debug_nans`` treats a
    jitted call's outputs. The port checks every step's loss and gradients
    in training and policy-gradient fine-tuning
    (``train.value_and_grad``), the dev pass's loss, and the forward
    outputs of every mode: the log-probs of predict, align, pseudolabel,
    the dev CER, a stream's chunks and an export's run on its example
    input (the transducer's encoder output, the seq2seq decoder's
    log-probs or beam scores);
  * sanitize_pytree(): NaN and +-Inf of every float tensor replaced;
  * assert_all_finite(): raises FloatingPointError naming the first five
    non-finite leaves, in the JAX package's message form.
"""

from __future__ import annotations

import torch


def enable_nan_checks(enable: bool = True) -> None:
    """Anomaly mode with its NaN check on (or off) for the process, as the
    JAX package's flag is."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def nan_checks_enabled() -> bool:
    return torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()


def check_nans(tree, name: str) -> None:
    """With NaN checks on, raise FloatingPointError naming the first five
    leaves of `tree` (a tensor or a nested dict) that hold a NaN; +-Inf
    passes. Nothing is read while torch.export or torch.compile traces."""
    if not nan_checks_enabled() or torch.compiler.is_compiling():
        return
    nested = isinstance(tree, dict)
    bad = [path for path, leaf in (_leaves(tree) if nested else [("", tree)])
           if _is_float(leaf) and bool(torch.isnan(leaf).any())]
    if bad:
        raise FloatingPointError(f"NaN values in {name}"
                                 + (f": {bad[:5]}" if nested else ""))


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def sanitize_pytree(tree, replace: float = 0.0):
    """Replace NaN and +-Inf in every float tensor of a (nested) dict."""
    if isinstance(tree, dict):
        return {k: sanitize_pytree(v, replace) for k, v in tree.items()}
    if _is_float(tree):
        return torch.nan_to_num(tree, nan=replace, posinf=replace,
                                neginf=replace)
    return tree


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def assert_all_finite(tree, name: str = "pytree") -> None:
    bad = [path for path, leaf in _leaves(tree)
           if _is_float(leaf) and not bool(torch.isfinite(leaf).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")
