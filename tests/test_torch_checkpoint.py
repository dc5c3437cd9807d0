"""The port's checkpointer against ``repro.checkpoint``: a checkpoint the
JAX package writes loads into the port bit for bit, and one the port
writes loads into the JAX package bit for bit, with the same manifest
(the leaves in ``jax.tree_util`` order, the paths as ``_path_str`` gives
them); the rolling ``Checkpointer`` keeps the same three rounds and
reports the same latest round; a bfloat16 tensor is refused; the driver's
``ckpt_dir`` saves the run's parameters."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.core import get_task as jax_get_task
from repro.models import rnnt as jrnnt
from repro_torch.checkpoint import Checkpointer, load_pytree, save_pytree
from repro_torch.convert import params_from_jax
from repro_torch.core.plan import FederatedPlan
from repro_torch.core.task import get_task
from repro_torch.launch import train


@pytest.fixture(scope="module")
def params():
    """The tiny RNN-T's parameters: JAX's nested tree, and the port's dict
    in the model's own order (not the tree's)."""
    jparams = jax.tree.map(np.asarray, jrnnt.init_params(
        jax_get_task("asr-rnnt").bundle.config, jax.random.PRNGKey(0)))
    flat = params_from_jax(jparams)
    order = [n for n, _ in get_task("asr-rnnt").model.named_parameters()]
    assert order != list(flat)  # the leaf-order hazard is live
    return jparams, {n: flat[n] for n in order}


def _bitwise(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def test_a_jax_checkpoint_loads_into_the_port_bitwise(params, tmp_path):
    jparams, tparams = params
    base = str(tmp_path / "jax")
    jax_save(base, jparams, extra={"round": 7, "wire_bytes": 123})
    like = {n: torch.zeros_like(p) for n, p in tparams.items()}
    got, extra = load_pytree(base, like)
    _bitwise(got, tparams)
    assert extra == {"round": 7, "wire_bytes": 123}


def test_a_port_checkpoint_loads_into_jax_bitwise(params, tmp_path):
    jparams, tparams = params
    save_pytree(str(tmp_path / "port"), tparams, extra={"round": 2})
    jax_save(str(tmp_path / "jax"), jparams, extra={"round": 2})
    got, extra = jax_load(str(tmp_path / "port"), jax.tree.map(np.zeros_like, jparams))
    assert extra == {"round": 2}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        assert json.load(f) == json.load(g)
    with np.load(tmp_path / "port.npz") as f, np.load(tmp_path / "jax.npz") as g:
        assert sorted(f.files) == sorted(g.files)
        for k in g.files:
            np.testing.assert_array_equal(f[k], g[k])


def test_the_loaded_tree_takes_the_like_trees_dtype_and_refuses_another_tree(params, tmp_path):
    _, tparams = params
    save_pytree(str(tmp_path / "c"), tparams)
    like = {n: torch.zeros(p.shape, dtype=torch.float64) for n, p in tparams.items()}
    got, _ = load_pytree(str(tmp_path / "c"), like)
    assert all(t.dtype == torch.float64 for t in got.values())
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "c"), dict(list(like.items())[:-1]))


def test_rolling_checkpoints_keep_three_rounds_as_the_reference(params, tmp_path):
    jparams, tparams = params
    ours, theirs = Checkpointer(str(tmp_path / "t")), JaxCheckpointer(str(tmp_path / "j"))
    assert ours.latest_round() is None and ours.restore_latest(tparams) is None
    for r in (1, 2, 10, 3, 4):
        ours.save(r, tparams, extra={"participants_mean": 2.5})
        theirs.save(r, jparams, extra={"participants_mean": 2.5})
        assert ours.latest_round() == theirs.latest_round()
        assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert ours.latest_round() == 10
    assert sorted(os.listdir(tmp_path / "t")) == [f"ckpt_{r}.{e}" for r in (10, 3, 4)
                                                  for e in ("json", "npz")]
    got, extra = ours.restore_latest({n: torch.zeros_like(p) for n, p in tparams.items()})
    _bitwise(got, tparams)
    assert extra == {"round": 10, "participants_mean": 2.5}


def test_bfloat16_is_refused(tmp_path):
    with pytest.raises(ValueError, match="bfloat16"):
        save_pytree(str(tmp_path / "b"), {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert not (tmp_path / "b.npz").exists()


def test_the_driver_checkpoints_its_parameters(tmp_path):
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=2)
    state, hist = train.run_federated(task, task.make_corpus(0), plan, rounds=3, device="cpu",
                                      eval_examples=0, ckpt_dir=str(tmp_path),
                                      log=lambda *_: None)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_round() == 3
    got, extra = ckpt.restore_latest({n: torch.zeros_like(p) for n, p in state.params.items()})
    _bitwise(got, state.params)
    assert extra == {"round": 3, "wire_bytes": hist["wire_bytes_total"],
                     "participants_mean": 2.0}
