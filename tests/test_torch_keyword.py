"""The port's keyword classifier (``repro_torch/models/keyword.py``) and its
task's ``err`` metric against the JAX package's, JAX's parameters carried
across: ``forward``, ``loss_fn`` (ce and acc, weighted), ``predict``, and
the keyword task's evaluation, per-client quality and per-client loss on
``default_corpus``'s splits and panel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clienteval import ClientEvalPlane as JaxPanel
from repro.core.task import get_task as jax_get_task
from repro.models import keyword as jkw
from repro_torch.convert import params_from_jax
from repro_torch.core.clienteval import ClientEvalPlane
from repro_torch.core.task import get_task
from repro_torch.models import keyword as tkw

# fp32 logits and losses: the same sums in another order (about 1e-7 seen)
TOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    jtask = jax_get_task("keyword")
    jparams = jax.tree.map(np.asarray, jtask.bundle.init(jax.random.PRNGKey(0)))
    corpus = jtask.make_corpus(0)
    ev = corpus.eval_split(32)
    weight = np.ones((32,), np.float32)
    weight[::5] = 0.0
    batch = {"features": ev["features"], "labels": ev["labels"], "frame_len": ev["frame_len"],
             "weight": weight}
    cfg = jtask.bundle.config
    logits = jax.jit(lambda p, f, n: jkw.forward(cfg, p, f, n))(
        jparams, ev["features"], ev["frame_len"])
    loss, parts = jax.jit(lambda p, b: jkw.loss_fn(cfg, p, b))(
        jparams, jax.tree.map(jnp.asarray, batch))
    return {"task": jtask, "params": jparams, "corpus": corpus, "batch": batch,
            "logits": np.asarray(logits), "loss": float(loss),
            "parts": {k: float(v) for k, v in parts.items()},
            "predict": np.asarray(jkw.predict(cfg, jparams, ev["features"], ev["frame_len"]))}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_config_and_parameters_are_the_references(reference):
    task = get_task("keyword")
    assert task.config.__dict__ == reference["task"].bundle.config.__dict__
    mine = task.init_params(torch.Generator().manual_seed(0))
    want = params_from_jax(reference["params"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in want.items()}


def test_forward_and_predict_match_jax(reference):
    cfg, params = get_task("keyword").config, params_from_jax(reference["params"])
    b = _torch(reference["batch"])
    logits = tkw.forward(cfg, params, b["features"], b["frame_len"])
    want = reference["logits"]
    assert np.abs(logits.numpy() - want).max() <= TOL * max(1.0, np.abs(want).max())
    assert np.array_equal(tkw.predict(cfg, params, b["features"], b["frame_len"]).numpy(),
                          reference["predict"])
    assert np.array_equal(tkw.class_of(b).numpy(), reference["batch"]["labels"][:, 0])


def test_loss_ce_and_acc_match_jax(reference):
    task = get_task("keyword")
    loss, parts = task.loss_fn(params_from_jax(reference["params"]), _torch(reference["batch"]))
    np.testing.assert_allclose(float(loss), reference["loss"], rtol=TOL)
    np.testing.assert_allclose(float(parts["ce"]), reference["parts"]["ce"], rtol=TOL)
    assert float(parts["acc"]) == pytest.approx(reference["parts"]["acc"], abs=1e-7)


def test_err_evaluation_matches_jax(reference):
    task = get_task("keyword")
    got = task.evaluate(params_from_jax(reference["params"]), task.make_corpus(0), 24)
    want = reference["task"].evaluate(reference["params"], reference["corpus"], 24)
    assert got == want
    assert task.quality_metric == "err" and 0.0 <= got["quality"] <= 1.0


def test_err_panel_quality_and_loss_match_jax(reference):
    task = get_task("keyword")
    plane = ClientEvalPlane(task, task.make_corpus(0), clients=6, n=4)
    got = plane.measure(params_from_jax(reference["params"]))
    jplane = JaxPanel(reference["task"], reference["corpus"], clients=6, n=4)
    want = jplane.measure(reference["params"])
    assert plane.client_ids.tolist() == jplane.client_ids.tolist()
    np.testing.assert_allclose(got["client_loss"], want["client_loss"], rtol=TOL)
    np.testing.assert_allclose(got["client_quality"], want["client_quality"], rtol=0, atol=1e-7)
    assert plane.curves()["quality_metric"] == "err"
