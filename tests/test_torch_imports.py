"""The port stands alone: no module of pg_asr_tpu_torch, and not
chip_smoke.py, imports the JAX package (pg_asr_tpu), jax or flax, even a
JAX-package module that imports no jax. What the port needs of such modules
it keeps as its own copies; the config schema is one of them, and one
config.json reads in both packages.
"""

import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import pg_asr_tpu.config as jax_config
import pg_asr_tpu_torch
import pg_asr_tpu_torch.config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# `import pg_asr_tpu`, `from pg_asr_tpu.x import y`, `import jax.numpy`...;
# the word boundary lets pg_asr_tpu_torch through
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(pg_asr_tpu|jax|jaxlib|flax)(?:[.\s,]|$)",
    re.MULTILINE)


def _port_sources() -> list[str]:
    root = os.path.dirname(pg_asr_tpu_torch.__file__)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_of_the_port_imports_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 15
    bad = {}
    for path in sources:
        with open(path) as fo:
            hits = FORBIDDEN.findall(fo.read())
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad


def test_pattern_allows_the_port_and_catches_the_jax_package():
    assert not FORBIDDEN.search("from pg_asr_tpu_torch.data import Batch\n")
    assert not FORBIDDEN.search("import pg_asr_tpu_torch\n")
    for line in ("import pg_asr_tpu\n", "from pg_asr_tpu.config import X\n",
                 "    from pg_asr_tpu import metrics\n", "import jax.numpy\n",
                 "from flax import serialization\n"):
        assert FORBIDDEN.search(line), line


def test_importing_every_module_of_the_port_loads_no_jax_package():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        pg_asr_tpu_torch.__path__, "pg_asr_tpu_torch."))
    assert "pg_asr_tpu_torch.train" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('pg_asr_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sections(module):
    return {f.name: f.type for f in dataclasses.fields(module.Config)}


def test_config_schema_is_a_field_for_field_copy():
    jax_cfg, port_cfg = jax_config.Config(), port_config.Config()
    assert jax_cfg.to_json() == port_cfg.to_json()
    assert list(_sections(jax_config)) == list(_sections(port_config))
    for name in _sections(jax_config):
        j = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jax_cfg, name))]
        p = [(f.name, f.default) for f in dataclasses.fields(
            getattr(port_cfg, name))]
        assert j == p, name


def _non_default(module):
    c = module.Config()
    return c.replace(
        model=dataclasses.replace(c.model, hidden_size=64, num_layers=2,
                                  dtype="bfloat16", dropout=0.1),
        features=dataclasses.replace(c.features, kind="mfcc", n_mfcc=13),
        train=dataclasses.replace(c.train, batch_size=8, learning_rate=1e-3,
                                  lr_schedule="warmup_cosine",
                                  mesh_shape=(2, 2),
                                  mesh_axes=("data", "model")),
        decode=dataclasses.replace(c.decode, beam_size=4))


@pytest.mark.parametrize("writer,reader", [(jax_config, port_config),
                                           (port_config, jax_config)])
def test_config_json_round_trips_between_packages(writer, reader):
    """A config.json written by either package reads in the other and
    writes back the same JSON, which reads back to the writer's config."""
    cfg = _non_default(writer)
    text = cfg.to_json()
    other = reader.Config.from_json(text)
    assert other.to_json() == text
    assert other == _non_default(reader)
    assert writer.Config.from_json(other.to_json()) == cfg
