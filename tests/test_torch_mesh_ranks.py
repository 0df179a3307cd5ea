"""Shared by the tests of the port's ``expert``, ``fsdp``, ``model``,
``pipe`` and ``seq`` mesh axes (tests/test_torch_expert.py,
tests/test_torch_fsdp.py, tests/test_torch_tensor.py,
tests/test_torch_pipeline.py, tests/test_torch_sequence.py; no test of its
own): four CPU rank processes over gloo that run every case of a test
file, and the JAX package's ``ParallelPlan`` steps on the same mesh of
forced host devices, on the same seeded numpy batches and weights
(``convert.params_from_jax``).

The four processes first join one group of 4 for the cases of a 4-rank
mesh (``data=2,expert=2``, ``data=2,fsdp=2``), then split into two groups
of 2, ranks 0-1 and 2-3, which run the 2-rank cases side by side. Each
group is torch.distributed's process group with the mesh's axis groups
made in it (``dist.new_group``), as a run of the CLI makes them; every
process has a hard timeout.

Each step case shards the JAX weights through the rank's ``GroupRank``
(``shard``), runs the eval step, then 2 (or 4) steps of the port's train or
policy-gradient step, and records its losses, the shapes and bytes it
holds, and its parameters gathered back (``unshard``). The clip is 1e-8:
it engages at every step, and the clipped gradients lie far below AdamW's
epsilon, where an update is linear in the gradient, so that a global norm
counted twice or once too few moves every parameter by a third or more
of its step.
"""

import concurrent.futures
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from pg_asr_tpu import train as jax_train
from pg_asr_tpu.parallel import driver as jax_driver
from pg_asr_tpu.parallel import mesh as jax_mesh
from pg_asr_tpu.rl import reinforce as jrl
from pg_asr_tpu_torch.convert import params_from_jax
from tests.test_torch_mesh import _start, _wait

TIMEOUT = 300  # seconds, the four processes of a file (under xdist)
CLIP = 1e-8  # train.grad_clip of the step cases
RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_mesh.py's
KEYS = ("wave", "ns", "labels", "label_lens")

_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from pg_asr_tpu_torch.config import Config
from pg_asr_tpu_torch.parallel import mesh
from pg_asr_tpu_torch.rl.reinforce import make_pg_step
from pg_asr_tpu_torch.train import (AdamW, _copy, _ema_update, make_eval_step,
                                    make_plan, make_train_step, train)

d, rank = sys.argv[1], int(sys.argv[2])
out = {}
for g, group in enumerate(json.load(open(os.path.join(d, "groups.json")))):
    if rank not in group["ranks"]:
        continue
    # the group's first rank takes a free port just before it binds it and
    # passes it on in a file: a port chosen when the processes start could
    # be taken by another process's connection by the time a later group
    # joins
    port_file = os.path.join(d, f"group{g}.port")
    if group["ranks"].index(rank) == 0:
        with open(port_file + ".tmp", "w") as fo:
            fo.write(str(mesh.free_port()))
        os.replace(port_file + ".tmp", port_file)
    end = time.monotonic() + 120
    while not os.path.exists(port_file):
        assert time.monotonic() < end, f"no {port_file}"
        time.sleep(0.02)
    with open(port_file) as fo:
        port = int(fo.read())
    mesh.init_distributed(f"127.0.0.1:{port}", len(group["ranks"]),
                          group["ranks"].index(rank), timeout_s=120)
    try:
        for name in group["cases"]:
            case = json.load(open(os.path.join(d, name + ".case.json")))
            with open(os.path.join(d, name + ".json")) as fo:
                cfg = Config.from_json(fo.read())
            if case["kind"] == "run":
                train(case["corpus"], case["model"], config=cfg, device="cpu")
                continue
            # finetune_pg's ranks: a pipe or seq group's are replicas
            dp = mesh.GroupRank("cpu", make_plan(
                cfg, replicas=case["kind"] == "pg"))
            params = dp.shard(torch.load(os.path.join(d, name + ".pt")))
            npz = np.load(os.path.join(d, name + ".npz"))
            arrays = [torch.from_numpy(a) for a in mesh.local_rows(
                tuple(npz[k] for k in ("wave", "ns", "labels", "label_lens")),
                dp.rank, dp.world)]
            gen = torch.Generator().manual_seed(0)
            res = {"losses": [], "rows": int(arrays[0].shape[0]),
                   "shapes": {k: tuple(v.shape) for k, v in params.items()}}
            if case["kind"] == "train":
                res["eval"] = make_eval_step(cfg, dp)(params, *arrays).item()
            if case["kind"] in ("train", "steps"):
                opt = AdamW(cfg, params, dp=dp)
                step = make_train_step(cfg, opt, dp)
            else:
                opt = AdamW(cfg, params,
                            learning_rate=cfg.train.learning_rate * 0.1,
                            weight_decay=1e-4, dp=dp)
                step = make_pg_step(cfg, opt, dp=dp)
            ema = _copy(params) if cfg.train.ema_decay > 0 else None
            for _ in range(case["steps"]):
                loss = step(params, gen, *arrays)
                if ema is not None:
                    _ema_update(ema, params, cfg.train.ema_decay)
                res["losses"].append(
                    (loss[0] if case["kind"] == "pg" else loss).item())
            res["resident"] = sum(t.numel() * t.element_size()
                                  for tree in (params, opt.mu, opt.nu)
                                  for t in tree.values())
            res["params"] = dp.unshard(params)
            if ema is not None:
                res["ema"] = dp.unshard(ema)
            out[name] = res
    finally:
        mesh.destroy_distributed()
torch.save(out, os.path.join(d, f"rank{rank}.pt"))
print("RANK_OK", flush=True)
"""


def mesh_of(spec: str) -> dict:
    """train.mesh_shape / mesh_axes of a spec: 'data=2,fsdp=2'."""
    shape, axes = jax_driver.parse_mesh_spec(spec)
    return {"mesh_shape": shape, "mesh_axes": axes}


def jax_tree(jcfg) -> dict:
    """The JAX package's initial weights of a config, as numpy."""
    return jax.tree_util.tree_map(np.asarray, jax_train.init_model_params(
        jax.random.PRNGKey(0), jcfg))


def jax_names(tree) -> dict:
    """{port name: leaf} of a JAX tree (the path joined by dots, as
    ``convert.params_from_jax`` names it)."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", "")))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_ranks(d: str, cases: dict, groups: list, meanwhile=None) -> dict:
    """Run `cases` ({name: (config JSON, kind, steps, tree, batch)}, kind
    "train" (the eval step, then the train steps), "steps" (the train steps
    alone), "pg" or "run": a train() call, whose tree names the corpus and
    the model directory) in the four processes, `groups` a list of (ranks,
    case names) in order, and `meanwhile()` in this process while they run.
    Returns {name: [each rank's result, in its group's rank order]} and,
    under "meanwhile", what `meanwhile` returned."""
    for name, (text, kind, steps, tree, batch) in cases.items():
        with open(os.path.join(d, name + ".json"), "w") as fo:
            fo.write(text)
        case = {"kind": kind, "steps": steps}
        if kind == "run":
            case.update(corpus=tree[0], model=tree[1])
        else:
            torch.save(params_from_jax(tree), os.path.join(d, name + ".pt"))
            np.savez(os.path.join(d, name + ".npz"),
                     **dict(zip(KEYS, batch)))
        with open(os.path.join(d, name + ".case.json"), "w") as fo:
            json.dump(case, fo)
    with open(os.path.join(d, "groups.json"), "w") as fo:
        json.dump([{"ranks": ranks, "cases": names}
                   for ranks, names in groups], fo)
    worker = os.path.join(d, "worker.py")
    with open(worker, "w") as fo:
        fo.write(_WORKER)
    procs = [_start([sys.executable, worker, d, str(r)]) for r in range(4)]
    try:
        done = meanwhile() if meanwhile is not None else None
    finally:
        outs = _wait(procs, TIMEOUT)
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in out, out
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(4)]
    out = {name: [ranks[r][name] for r in members if name in ranks[r]]
           for members, names in groups for name in names}
    out["meanwhile"] = done
    return out


def jax_cases(cases: dict) -> dict:
    """``jax_steps`` of every case ({name: (JAX config, kind, steps, tree,
    batch)}), compiled and run in threads of this process (XLA compiles
    outside the interpreter lock) with XLA's optimizations off, which
    costs a third of the compile and changes no result beyond float32
    rounding: {name: its result}."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
            futures = {name: pool.submit(jax_steps, jcfg, kind, tree, steps,
                                         batch)
                       for name, (jcfg, kind, steps, tree, batch)
                       in cases.items()}
            return {name: f.result() for name, f in futures.items()}
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


def jax_steps(jcfg, kind: str, tree: dict, steps: int, batch) -> dict:
    """The JAX package's steps on the config's mesh (its ParallelPlan:
    placement, batch multiple, the train steps (GSPMD, or the pipeline's
    and the sequence axis's shard_map programs) and, for "train", the
    eval step; for "pg"
    finetune_pg's optimizer, replicated weights and make_pg_step), with
    the EMA of every step when train.ema_decay > 0: {losses, eval, params,
    ema}, the trees in the port's layout (a pipeline's canonical tree,
    ``ParallelPlan.canonical_params``)."""
    t = jcfg.train
    m = jax_mesh.make_mesh(t.mesh_shape, t.mesh_axes,
                           devices=jax.devices()[:math.prod(t.mesh_shape)])
    plan = jax_driver.ParallelPlan(jcfg, m)
    arrays = jax_mesh.shard_batch_arrays(batch, m, plan.batch_multiple)
    start = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {"losses": [], "eval": None}
    if kind in ("train", "steps"):
        params = plan.place_params(start)
        opt = jax_train.make_optimizer(jcfg)
        opt_state = plan.place_opt_state(opt.init(start))
        if kind == "train":
            out["eval"] = float(plan.make_eval_step()(params, *arrays))
        step = plan.make_train_step(opt)
    else:
        params = jax_mesh.replicate(start, m)
        opt = optax.chain(optax.clip_by_global_norm(t.grad_clip),
                          optax.adamw(t.learning_rate * 0.1))
        opt_state = jax_mesh.replicate(opt.init(start), m)
        step = jrl.make_pg_step(jcfg, opt, m)
    ema = (jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), params)
           if t.ema_decay > 0 else None)
    # placed as the step returns it, so that the second step reuses the
    # first one's program
    rng = jax_mesh.replicate(jax.random.PRNGKey(0), m)
    for _ in range(steps):
        params, opt_state, rng, loss, *_ = step(params, opt_state, rng,
                                                *arrays)
        if ema is not None:
            ema = jax_train._ema_update(ema, params, t.ema_decay)
        out["losses"].append(float(loss))

    def port(tree):
        if kind != "pg":  # a pipeline's stacked stages back to the blocks
            tree = plan.canonical_params(tree)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))

    out["params"] = port(params)
    out["ema"] = port(ema) if ema is not None else None
    return out


def assert_matches(ranks: list, want: dict) -> None:
    """Every rank's losses, eval loss, parameters (and EMA) against the
    reference steps (the JAX package's, or the port's one process) at RTOL
    / ATOL; the ranks' gathered parameters equal bit for bit."""
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL,
                                   atol=ATOL)
        if want["eval"] is not None:
            np.testing.assert_allclose(r["eval"], want["eval"], rtol=RTOL,
                                       atol=ATOL)
        for tree in ("params", "ema"):
            if want[tree] is None:
                continue
            for k, v in want[tree].items():
                np.testing.assert_allclose(r[tree][k].numpy(), v.numpy(),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{tree} {k}")
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert all(torch.equal(r["params"][k], ranks[0]["params"][k])
                   for k in ranks[0]["params"])


def moved(ranks: list, tree: dict) -> float:
    """The largest parameter change of the port's steps (the steps must
    move the parameters well past the tolerance for the comparison to see
    a wrong clip)."""
    start = params_from_jax(tree)
    return max((ranks[0]["params"][k] - v).abs().max().item()
               for k, v in start.items())


def mesh_devices(spec: str) -> tuple:
    """(the JAX mesh of a spec over the first host devices, the device at
    each row-major mesh position, which is the port's rank)."""
    shape, axes = jax_driver.parse_mesh_spec(spec)
    m = jax_mesh.make_mesh(shape, axes,
                           devices=jax.devices()[:math.prod(shape)])
    return m, list(np.asarray(m.devices).reshape(-1))
