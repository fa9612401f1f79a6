"""The recsys models' training path on the port against the JAX package,
on the CPU at every recsys smoke config: each ``loss_fn`` and every
gradient leaf (carried back with ``convert.params_to_numpy``) against
``jax.value_and_grad`` of the JAX ``loss_fn`` on the same parameters
(``recsys_from_numpy``) and the same ``RecsysPipeline`` batch (the JAX
launcher's shapes); BERT4Rec's Cloze masking and negatives are derived
from the ids with the reference's wrapping int32 arithmetic, its
encoder's attention differentiated through the autograd function of
``ops.flash_attention``; and one ``train_step`` of one microbatch equals
``_recsys_cell``'s step (``adamw_update`` of the gradient).  Tolerances
as ``test_torch_train_lm.py`` states them (every parameter here is
float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_lm import LOSS_RTOL, grads_close

from repro.configs.registry import get_arch as ref_arch
from repro.data.pipeline import PipelineState, RecsysPipeline
from repro.launch.steps import _recsys_module
from repro.train import optimizer as ref_opt
from repro_torch.configs.registry import get_arch
from repro_torch.launch.steps import train_state, train_step
from repro_torch.models import convert
from repro_torch.models.recsys import bert4rec, recsys_module
from repro_torch.train.optimizer import AdamWConfig

RECSYS_ARCHS = ("dien", "mind", "dcn-v2", "bert4rec")


def _setup(arch, rows=8, step=1):
    cfg, ref_cfg = get_arch(arch).smoke_cfg, ref_arch(arch).smoke_cfg
    M = _recsys_module(arch)
    params = M.init(ref_cfg, jax.random.key(1))
    if arch == "dcn-v2":
        pipe = RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.vocab_per_field, 4, rows, seed=2)
    else:
        seq = getattr(cfg, "seq_len", None) or cfg.hist_len
        pipe = RecsysPipeline(4, 4, cfg.vocab, seq, rows, seed=2)
    batch = pipe.batch(PipelineState(step))
    model = convert.recsys_from_numpy(jax.tree.map(np.asarray, params), arch, cfg, device="cpu")
    return M, ref_cfg, params, model.requires_grad_(True), batch


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_loss_and_every_gradient_equal_the_reference(arch):
    M, ref_cfg, params, model, batch = _setup(arch)
    want_loss, want = jax.value_and_grad(
        lambda p: M.loss_fn(p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    loss = recsys_module(arch).loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    grads = convert.params_to_numpy(model, {n: p.grad for n, p in model.named_parameters()})
    grads_close(grads, jax.tree.map(np.asarray, want))


def test_bert4rec_cloze_arithmetic_wraps_as_int32():
    ids = np.array([0, 1, 999_999, 44_488, 2**20, 777_777], dtype=np.int32)
    with np.errstate(over="ignore"):
        want_h = (ids * np.int32(48271) + np.int32(97)) % 1000
        want_neg = (ids * np.int32(40503) + np.int32(7)) % 1000
    t = torch.from_numpy(ids).long()
    got_h = torch.remainder(bert4rec._int32_wrapped(t * 48271 + 97), 1000)
    got_neg = torch.remainder(bert4rec._int32_wrapped(t * 40503 + 7), 1000)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_neg.numpy(), want_neg)


@pytest.mark.parametrize("arch", ["dcn-v2", "bert4rec"])
def test_train_step_equals_the_reference_cell_step(arch):
    M, ref_cfg, params, model, batch = _setup(arch, step=3)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    g = jax.grad(lambda p: M.loss_fn(p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}))(
        params)
    want, want_state = ref_opt.adamw_update(
        ref_opt.AdamWConfig(**ocfg), g, ref_opt.adamw_init(ref_opt.AdamWConfig(**ocfg), params),
        params)
    state = train_state(model, AdamWConfig(**ocfg))
    train_step(model, state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    assert int(state.opt["step"]) == 1
    # AdamW divides each gradient by its own magnitude (+ eps = 1e-8), so
    # where a gradient element is within a few eps of 0 its float32
    # rounding moves the update by a visible share of lr: parameters are
    # held within 1e-5 relative or 1e-3·lr absolute.
    for got, w in zip(jax.tree.leaves(convert.params_to_numpy(model)), jax.tree.leaves(want),
                      strict=True):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5, atol=1e-3 * ocfg["lr"])
    nu = convert.params_to_numpy(model, state.opt["nu"])
    scale = max(float(np.abs(np.asarray(w)).max()) for w in jax.tree.leaves(want_state["nu"]))
    for got, w in zip(jax.tree.leaves(nu), jax.tree.leaves(want_state["nu"]), strict=True):
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-4, atol=1e-5 * scale)
