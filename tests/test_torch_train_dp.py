"""Data-parallel ``api.train`` (the reference's ``(n_data, 1)`` mesh:
``mesh.data_mesh``, ``mesh.batch_sharding``, the gradient average in
``train_step.accumulate``) on the CPU.

The port's side runs in ONE spawn of three processes
(``torch_train_dp_ranks``, which imports no jax; ``torch_world.World``):
a world of 2 gloo ranks (``file://`` rendezvous under tmp_path) and a
world of 1 with no process group run the same ``api.train --smoke
--device cpu --total-steps 2`` command lines side by side, for the
selector (also at ``--grad-accum-steps 2``), ``sft`` with LoRA,
``dynamic``, ``dpo``, ``grpo`` under the ``grpo``, ``bnpo`` and
``dr_grpo`` reductions, OV's selector, and batch 3 over 2 ranks (gcd 1:
rank 1 idles). GRPO's rollouts are cut to lengths that vary with their
seed (``torch_train_dp_ranks._ragged``), so that the ranks' completion
token counts differ: ``bnpo`` normalises by the whole batch's count and
``dr_grpo`` by its rows, which a rank's own count or rows would get
wrong. The JAX side runs here meanwhile: one selector step of
the reference's ``train_step`` on a JAX (2, 1) data mesh (8 virtual CPU
devices from conftest), the batch ``device_put`` by ``batch_sharding``,
against the port's step over the world of 2 on the same weights and
samples.

Tolerances: step-1 averaged gradients within atol 1e-5, rtol 0 (the
scorer tests' absolute rule; the selector's gradients are ~1e-6 here, so
also within 1e-4 of the largest |gradient| of the update, the relative
rule of tests/test_torch_train.py); logged losses and metrics rtol 1e-5
(atol 1e-6 for values that are zero up to rounding: GRPO's
advantage_mean of group-normalised rewards); the two ranks' gradients
and trained tensors bit-equal. Two steps: the first has lr 0, so the
second's rollouts and inputs are those of the first's policy in both
worlds (a later step's Adam update turns rounding-level gradients into
lr-sized steps that differ between the worlds, and GRPO's sampled
rollouts then part). A planted fault (the gradients left unaveraged)
must fail the comparison and leave the ranks apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_params import jax_param_tree
from torch_train_dp_ranks import arrays, train_rank
from torch_world import World

from visionselector_tpu.core import mesh as jmesh
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.train import data as jdata
from visionselector_tpu.train import train_step as jstep
from visionselector_tpu_torch.core import mesh as tmesh
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.train import data as tdata

COMMON = ["--smoke", "--device", "cpu", "--total-steps", "2",
          "--batch-size", "2", "--log-steps", "1"]
GRPO = ["--method", "grpo", "--num-generations", "2",
        "--max-completion-length", "4"]
CASES = {
    "selector": [],
    "selector_accum2": ["--grad-accum-steps", "2"],
    "sft_lora": ["--method", "sft", "--lora-rank", "8"],
    "dynamic": ["--method", "dynamic"],
    "dpo": ["--method", "dpo"],
    "grpo": GRPO + ["--grpo-loss-type", "grpo"],
    "bnpo": GRPO + ["--grpo-loss-type", "bnpo"],
    "dr_grpo": GRPO + ["--grpo-loss-type", "dr_grpo"],
    "ov_selector": ["--family", "llava_ov15"],
    "batch3": ["--batch-size", "3"],
}
FAULT = "selector_no_grad_sum"
S_BUCKET, T_BUCKET, BUDGET = 128, 64, 0.25
K_MAX = max(1, int(S_BUCKET // 4 * BUDGET))
SCHED = dict(total_steps=10, lr=5e-3)


def _samples(b=2, seed=0):
    """(JAX samples, the port's stacked host batch) of the same images and
    ids."""
    rng = np.random.RandomState(seed)
    js, ts = [], []
    for i in range(b):
        img = (rng.rand(112, 84 + 28 * i, 3) * 255).astype(np.uint8)
        kw = dict(prompt_before=[101, 102], prompt_after=[103],
                  answer_ids=[201 + i, 202, 203, 204][: 3 + i % 2],
                  budget=BUDGET, s_bucket=S_BUCKET, t_bucket=T_BUCKET,
                  min_pixels=1, max_pixels=10**9)
        js.append(jdata.build_train_sample(jax_tiny(), img, **kw))
        ts.append(tdata.build_train_sample(qwen25vl_tiny(), img, **kw))
    return js, tdata.stack_samples(ts)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp"))
    cases = [(n, COMMON + extra, (1, 2),
              ("ragged_rollouts",) if "grpo" in extra else ())
             for n, extra in CASES.items()]
    cases.append((FAULT, COMMON, (2,), ("no_grad_sum",)))
    tree = jax_param_tree(jax_tiny(), seed=5, scorer_std=0.02)
    js, host = _samples()
    run = World((2, 1), tmp, train_rank, dict(
        tmp=tmp, cases=cases, tree=tree, batch=host, sched=SCHED,
        k_max=K_MAX))
    jcfg, jparams = jax_tiny(), jax.tree.map(jnp.asarray, tree)
    jm = jmesh.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    spec = jmesh.batch_sharding(jm)
    jb = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), spec(x)),
                      jdata.stack_samples(js))
    frozen = jmesh.shard_params(jparams, jm)
    jsched = jstep.ScheduleConfig(**SCHED)
    _, jm_metrics = jstep.train_step(jstep.init_train_state(jparams, jsched),
                                     frozen, jb, jcfg, K_MAX, jsched)
    reg = jm_metrics["reg_weight"]
    want_grad = jax.jit(jax.grad(lambda sp: jstep.batch_loss(
        sp, frozen, jb, jcfg, reg, K_MAX)[0]))(jparams["scorer"])
    got = run.results()
    for n, ranks in got.items():
        for r, res in enumerate(ranks):
            assert "error" not in res, f"world {n} rank {r}:\n{res['error']}"
    return dict(w1=got[1][0], w2=got[2], jax=(
        {k: float(v) for k, v in jm_metrics.items()},
        {k: np.asarray(v) for k, v in want_grad.items()}))


def _same_metrics(got_log, want_log):
    assert [m["step"] for m in got_log] == [m["step"] for m in want_log]
    for got, want in zip(got_log, want_log):
        assert got.keys() == want.keys()
        for k in got:
            if k != "wall_s":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)


def _same_grads(got: dict, want: dict):
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=0,
                                   err_msg=name)
        assert np.abs(got[name] - w).max() <= 1e-4 * top, name


@pytest.mark.parametrize("name", [n for n in CASES if n != "batch3"])
def test_data_parallel_cli_equals_one_process(world, name):
    """World 2 against world 1 on the same command line: two log lines
    (rank 0's) with the same losses and metrics, the same averaged step-1
    gradients, both ranks' gradients and trained tensors bit-equal; rank 1
    prints no log line and saves nothing."""
    want, (r0, r1) = world["w1"][name], world["w2"]
    r0, r1 = r0[name], r1[name]
    assert want["rc"] == r0["rc"] == r1["rc"] == 0
    assert [m["step"] for m in want["log"]] == [1, 2]
    _same_metrics(r0["log"], want["log"])
    got0, got1, ref = (arrays(r["arrays"]) for r in (r0, r1, want))
    _same_grads(got0["grad"], ref["grad"])
    for kind in ("grad", "trained"):
        assert got1[kind].keys() == got0[kind].keys() and got0[kind]
        for n, a in got0[kind].items():
            np.testing.assert_array_equal(got1[kind][n], a, err_msg=n)
    assert "data parallel over 2 of 2 ranks" in r0["stdout"]
    assert not [ln for ln in r1["stdout"].splitlines()
                if ln.startswith("{") or "[train] saved" in ln]


def test_batch_that_does_not_split_leaves_rank_1_idle(world):
    """Batch 3 over 2 ranks: gcd 1, so rank 0 trains alone (the world-1
    run's log, bit for bit) and rank 1 prints one line to stderr, takes no
    step and returns 0."""
    want, (r0, r1) = world["w1"]["batch3"], world["w2"]
    r0, r1 = r0["batch3"], r1["batch3"]
    assert want["rc"] == r0["rc"] == r1["rc"] == 0
    assert r1["steps"] == 0 and r1["stdout"] == ""
    assert r1["stderr"].strip().count("\n") == 0 and "idle" in r1["stderr"]
    assert [{k: v for k, v in m.items() if k != "wall_s"}
            for m in r0["log"]] == [{k: v for k, v in m.items()
                                     if k != "wall_s"} for m in want["log"]]


def test_planted_unaveraged_gradients_are_caught(world):
    """The gradients left each rank's own (the metrics still averaged): the
    step-1 gradient comparison fails and the ranks' trained tensors
    part."""
    r0, r1 = (r[FAULT] for r in world["w2"])
    ref = arrays(world["w1"]["selector"]["arrays"])
    got0, got1 = arrays(r0["arrays"]), arrays(r1["arrays"])
    with pytest.raises(AssertionError):
        _same_grads(got0["grad"], ref["grad"])
    assert any(not np.array_equal(got1["trained"][n], a)
               for n, a in got0["trained"].items())


def test_data_parallel_step_matches_jax_data_mesh(world):
    """One selector update over the world of 2 (one sample a rank) against
    the reference's ``train_step`` on a JAX (2, 1) mesh with the batch
    ``device_put`` by ``batch_sharding``: loss, ce, bce and grad_norm
    within rtol 1e-5; the averaged scorer gradients within 1e-4 of each
    leaf's max |value| of ``jax.grad`` of the reference's batch loss
    (q_bias, zero analytically, within 1e-6 of the largest gradient on
    both sides); both ranks' gradients bit-equal."""
    want_m, want_g = world["jax"]
    s0, s1 = (r["dp_step"] for r in world["w2"])
    assert s0["local_rows"] == s1["local_rows"] == 1
    for k in ("loss", "ce", "bce", "grad_norm", "reg_weight"):
        np.testing.assert_allclose(s0["metrics"][k], want_m[k], rtol=1e-5,
                                   err_msg=k)
    top = max(float(np.abs(g).max()) for g in want_g.values())
    for name, w in want_g.items():
        got = s0["grad"][name]
        np.testing.assert_array_equal(s1["grad"][name], got)
        if name == "q_bias":
            assert np.abs(w).max() < 1e-6 * top
            assert np.abs(got).max() < 1e-6 * top
        else:
            err = np.abs(got - w).max() / np.abs(w).max()
            assert err < 1e-4, (name, err)


def test_mesh_grids_and_idle_ranks():
    """``Mesh.index`` on a (data, model) grid (rank r at (r // n_model, r %
    n_model)) and on the 1-D stage grid; ``placement`` lives in
    ``core.mesh`` (the CPU: gloo)."""
    for rank in range(8):
        m = tmesh.Mesh({"data": 4, "model": 2}, rank, torch.device("cpu"),
                       "gloo", {})
        assert (m.index("data"), m.index("model")) == divmod(rank, 2)
        s = tmesh.Mesh({"stage": 8}, rank, torch.device("cpu"), "gloo", {})
        assert s.index("stage") == rank and s.size("stage") == 8
    assert tmesh.placement("cpu", 1, 2) == (torch.device("cpu"), "gloo")
