"""The LM's training path on the port against the JAX package, on the
CPU at every ported LM smoke config: ``transformer.loss_fn`` and every
gradient leaf (carried back with ``convert.params_to_numpy``) against
``jax.value_and_grad`` of the JAX ``loss_fn`` on the same parameters
(``params_from_numpy``) and the same ``TokenPipeline`` batch; the block
remat (``remat="full"``) and the attention's autograd function give the
same; and one ``train_step`` over 2 microbatches (masters and AdamW state
carried across with ``opt_state_from_numpy``) equals ``_lm_cell``'s step
arithmetic (interleaved microbatches, gradients summed and halved,
``adamw_update``); with bf16 weights, the gradients the step hands AdamW
are ``_lm_cell``'s float32 sum of the microbatches' bf16 gradients, bit
for bit.

Tolerances.  The loss within 2e-6 relative.  A gradient element within
``GRAD_RTOL`` · (its own magnitude + the largest magnitude of the whole
gradient tree): float32 sums in another order (measured ≤ 8e-7 of that);
the tree's scale keeps leaves whose gradient nearly cancels (a tower's
last bias) from demanding float32 digits they do not have.  A leaf whose
reference parameter is bf16 (arctic-480b's ``param_dtype``) holds the
reference's float32 gradient rounded to bf16, so the port's is rounded
the same way and may lie one bf16 step (2**-7 relative) away where the
float32 values straddle a rounding boundary."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_arch
from repro.data.pipeline import PipelineState, TokenPipeline
from repro.models import transformer as JT
from repro.train import optimizer as ref_opt
from repro_torch.configs.registry import get_arch
from repro_torch.launch import steps
from repro_torch.launch.steps import microbatch, train_state, train_step
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig

LM_ARCHS = ("gemma3-4b", "qwen1.5-4b", "qwen1.5-32b", "qwen3-moe-30b-a3b", "arctic-480b")
GRAD_RTOL = 1e-5
LOSS_RTOL = 2e-6
BF16_STEP = 2**-7


def grads_close(got: dict, want: dict) -> None:
    """Every leaf of ``got`` (float32 numpy) against ``want`` (the JAX
    gradient tree) within the module's tolerances."""
    leaves_w = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves_g = jax.tree.leaves(got)
    assert len(leaves_g) == len(leaves_w)
    scale = max(float(np.abs(np.asarray(w, np.float32)).max()) for _, w in leaves_w)
    for g, (path, w) in zip(leaves_g, leaves_w, strict=True):
        w = np.asarray(w)
        rtol = GRAD_RTOL
        if w.dtype != np.float32:  # a bf16 parameter's gradient
            g = np.asarray(jnp.asarray(g).astype(w.dtype))
            rtol = BF16_STEP
        w, g = w.astype(np.float32), np.asarray(g, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = np.abs(g - w) / (np.abs(w) + scale)
        assert float(err.max()) <= rtol, (jax.tree_util.keystr(path), float(err.max()))


def _pair(arch, **overrides):
    cfg = dataclasses.replace(get_arch(arch).smoke_cfg, **overrides)
    ref_cfg = dataclasses.replace(ref_arch(arch).smoke_cfg, **overrides)
    params = JT.init(ref_cfg, jax.random.key(1))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return cfg, ref_cfg, params, model.requires_grad_(True)


def _batch(cfg, rows=2, seq=32, step=2):
    return TokenPipeline(cfg.vocab, seq, rows, seed=3).batch(PipelineState(step))


def _port_grads(model, batch):
    loss = T.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = convert.params_to_numpy(model, {n: p.grad for n, p in model.named_parameters()})
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_every_gradient_equal_the_reference(arch):
    cfg, ref_cfg, params, model = _pair(arch)
    batch = _batch(cfg)
    want_loss, want = jax.value_and_grad(
        lambda p: JT.loss_fn(p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    loss, grads = _port_grads(model, batch)
    assert loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    grads_close(grads, jax.tree.map(np.asarray, want))


def test_block_remat_and_ragged_chunks_equal_the_reference():
    """gemma3-4b smoke with ``remat="full"`` (each block checkpointed) and
    a sequence of 40 tokens (two whole loss chunks of 16, the tail of 8
    left out as the reference leaves it)."""
    cfg, ref_cfg, params, model = _pair("gemma3-4b", remat="full")
    batch = _batch(cfg, seq=40)
    want_loss, want = jax.value_and_grad(
        lambda p: JT.loss_fn(p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    loss, grads = _port_grads(model, batch)
    assert loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    grads_close(grads, jax.tree.map(np.asarray, want))


def test_params_round_trip_through_numpy():
    _, _, params, model = _pair("qwen3-moe-30b-a3b")
    back = convert.params_to_numpy(model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(back), strict=True):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))


def test_train_step_over_microbatches_equals_the_reference_cell_step():
    # gemma3-4b: qwen1.5's k bias has a gradient of float32 noise (a shift
    # of every key moves no softmax), which AdamW's normalisation blows up
    # to ±lr in either package, so its update is not comparable.
    cfg, ref_cfg, params, model = _pair("gemma3-4b")
    batch = _batch(cfg, rows=4, step=5)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    ref_state = ref_opt.adamw_init(ref_opt.AdamWConfig(**ocfg), params)
    # One step first, so the carried state is not zero.
    g0 = jax.grad(lambda p: JT.loss_fn(p, ref_cfg, {k: jnp.asarray(v) for k, v in
                                                   _batch(cfg, rows=4, step=4).items()}))(params)
    params, ref_state = ref_opt.adamw_update(ref_opt.AdamWConfig(**ocfg), g0, ref_state, params)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    model.requires_grad_(True)
    state = train_state(model, AdamWConfig(**ocfg))
    convert.opt_state_from_numpy(state, jax.tree.map(np.asarray, ref_state), model)
    # _lm_cell's step: interleaved microbatches, gradients summed then halved.
    micro = 2
    mbs = [{k: jnp.asarray(v[i::micro]) for k, v in batch.items()} for i in range(micro)]
    outs = [jax.value_and_grad(lambda p, m=m: JT.loss_fn(p, ref_cfg, m))(params) for m in mbs]
    gsum = jax.tree.map(lambda a, b: a + b, outs[0][1], outs[1][1])
    want_params, want_state = ref_opt.adamw_update(
        ref_opt.AdamWConfig(**ocfg), jax.tree.map(lambda g: g / micro, gsum), ref_state, params)
    want_loss = float(jnp.stack([o[0] for o in outs]).mean())
    loss = train_step(model, state, {k: torch.from_numpy(v) for k, v in batch.items()}, micro)
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert int(state.opt["step"]) == int(want_state["step"]) == 2
    got = convert.params_to_numpy(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want_params), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)
    mu = convert.params_to_numpy(model, state.opt["mu"])
    for g, w in zip(jax.tree.leaves(mu), jax.tree.leaves(want_state["mu"]), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-8)


def test_bf16_weights_sum_microbatch_gradients_in_float32(monkeypatch):
    """gemma3-4b smoke with bf16 weights, 3 microbatches: each
    microbatch's gradient of a bf16 weight is the bf16 cotangent the
    reference's cast hands its float32 parameter, and ``_lm_cell`` sums
    those in float32 (its accumulator takes the parameter's dtype), then
    divides by the count.  The gradients ``train_step`` hands AdamW are
    that sum, bit for bit; a sum in bf16 would not be."""
    cfg = dataclasses.replace(get_arch("gemma3-4b").smoke_cfg, dtype="bfloat16")
    model = T.init(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    assert model.embed.dtype == torch.bfloat16
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, rows=3, step=5).items()}
    micro = 3
    parts = []
    for i in range(micro):
        T.loss_fn(model, microbatch(batch, i, micro)).backward()
        parts.append({n: p.grad for n, p in model.named_parameters()})
        model.zero_grad(set_to_none=True)
    want = {n: sum(part[n].float() for part in parts) / micro for n in parts[0]}
    in_own_dtype = {n: (parts[0][n] + parts[1][n] + parts[2][n]).float() / micro for n in want}
    assert any(not torch.equal(in_own_dtype[n], want[n]) for n in want)

    seen = {}
    real = steps.adamw_update

    def recording(cfg_, grads, opt_state, params):
        seen.update({n: g.clone() for n, g in grads.items()})
        return real(cfg_, grads, opt_state, params)

    monkeypatch.setattr(steps, "adamw_update", recording)
    state = train_state(model, AdamWConfig(lr=1e-3, warmup_steps=0))
    train_step(model, state, batch, micro)
    assert seen.keys() == want.keys()
    for n, g in want.items():
        assert seen[n].dtype == torch.float32
        assert torch.equal(seen[n], g), n
    assert all(p.grad is None for p in model.parameters())
