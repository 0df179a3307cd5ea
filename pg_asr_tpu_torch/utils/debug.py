"""Numerical debugging helpers (counterpart of pg_asr_tpu/utils/debug.py),
over the port's flat state dicts (nested dicts are walked too):

  * enable_nan_checks(): the CLI's ``--debug_nans``. Turns on autograd's
    anomaly mode with its NaN check (a backward function that returns NaN
    raises, with the forward's traceback) and the checks that
    ``train.value_and_grad`` makes of every step's loss and gradients in
    training and policy-gradient fine-tuning;
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
