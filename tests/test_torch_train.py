"""The port's training substrate against the JAX package's: the data
pipeline (batches bit-equal for every ``(seed, step, shard)``), AdamW
(one and several steps from the same params, gradients and state equal
``repro.train.optimizer.adamw_update`` within float32 rounding: fp32 and
bf16 moments, the clip, the schedule), the checkpoint manager (the
reference's scenarios: round trip, retention and atomicity, corruption;
bf16 tensors bit for bit), the trainer (a restart continues bit for bit
like an uninterrupted run on the CPU) and the launcher
(``launch/train.py --config smoke --device cpu`` trains and writes
checkpoints; ``pna`` raises)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import PipelineState as RefState
from repro.data.pipeline import RecsysPipeline as RefRecsys
from repro.data.pipeline import TokenPipeline as RefToken
from repro.train import optimizer as ref_opt
from repro_torch.data.pipeline import PipelineState, RecsysPipeline, TokenPipeline
from repro_torch.launch import train as launcher
from repro_torch.launch.steps import microbatch, train_state, train_step
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig

# AdamW in float32 against XLA's: the same operations in the same order,
# but XLA may fuse or reassociate (the global norm's sum over leaves) and
# evaluate ``b ** step`` and ``cos`` in its own way: a few float32 ulps
# of each result after several steps.
ADAM_RTOL = 1e-6
ADAM_ATOL = 1e-7


# -- data pipeline -----------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 5, 0), (3, 5, 1), (11, 1234, 3)])
def test_token_batches_equal_the_reference(seed, step, shard):
    got = TokenPipeline(vocab_size=512, seq_len=33, batch_per_shard=5, seed=seed).batch(
        PipelineState(step), shard)
    want = RefToken(vocab_size=512, seq_len=33, batch_per_shard=5, seed=seed).batch(
        RefState(step), shard)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (2, 7, 0), (2, 7, 2), (9, 99, 1)])
def test_recsys_batches_equal_the_reference(seed, step, shard):
    kw = dict(n_dense=5, n_fields=3, vocab_size=50, hist_len=7, batch_per_shard=6, seed=seed)
    got = RecsysPipeline(**kw).batch(PipelineState(step), shard)
    want = RefRecsys(**kw).batch(RefState(step), shard)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_state_advances_and_microbatches_interleave():
    assert PipelineState(3).advance(2) == PipelineState(5)
    batch = {"tokens": torch.arange(12).reshape(6, 2), "targets": torch.arange(6)}
    parts = [microbatch(batch, i, 3) for i in range(3)]
    np.testing.assert_array_equal(parts[1]["tokens"].numpy(), [[2, 3], [8, 9]])
    np.testing.assert_array_equal(parts[2]["targets"].numpy(), [2, 5])


# -- AdamW -------------------------------------------------------------------


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (7, 5), "b": (5,), "emb": (33, 4)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_steps_equal_the_reference(moment_dtype, clip):
    rng = np.random.default_rng(0)
    cfg = dict(lr=0.05, weight_decay=0.1, warmup_steps=3, total_steps=12, clip_norm=clip,
               moment_dtype=moment_dtype)
    p_np = _tree(rng, SHAPES)
    params = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    state = opt.adamw_init(opt.AdamWConfig(**cfg), params)
    ref_params = {k: jnp.asarray(v) for k, v in p_np.items()}
    ref_state = ref_opt.adamw_init(ref_opt.AdamWConfig(**cfg), ref_params)
    assert state["mu"]["w"].dtype == getattr(torch, moment_dtype)
    for step in range(5):  # one step, then several with the state carried across
        g_np = _tree(rng, SHAPES, scale=3.0)
        params, state = opt.adamw_update(opt.AdamWConfig(**cfg),
                                         {k: torch.from_numpy(v) for k, v in g_np.items()},
                                         state, params)
        ref_params, ref_state = ref_opt.adamw_update(
            ref_opt.AdamWConfig(**cfg), {k: jnp.asarray(v) for k, v in g_np.items()},
            ref_state, ref_params)
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        for k in SHAPES:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(ref_params[k]),
                                       rtol=ADAM_RTOL, atol=ADAM_ATOL)
            for m in ("mu", "nu"):
                got = state[m][k].float().numpy()
                want = np.asarray(ref_state[m][k]).astype(np.float32)
                if moment_dtype == "bfloat16":  # one bf16 step apart at most
                    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-30)
                else:
                    np.testing.assert_allclose(got, want, rtol=ADAM_RTOL, atol=ADAM_ATOL)


def test_schedule_equals_the_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(opt.cosine_schedule(opt.AdamWConfig(**cfg), torch.tensor(float(step))))
        want = float(ref_opt.cosine_schedule(ref_opt.AdamWConfig(**cfg), jnp.float32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(opt.cosine_schedule(opt.AdamWConfig(**cfg), torch.tensor(0.0))) == 0.0


def test_adamw_minimizes_quadratic_and_clips():
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.adamw_init(cfg, params)
    for _ in range(150):
        params, state = opt.adamw_update(cfg, {"w": 2 * params["w"]}, state, params)
    assert float((params["w"] ** 2).sum()) < 1e-3
    cfg = opt.AdamWConfig(lr=0.0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    _, state = opt.adamw_update(cfg, {"w": torch.full((3,), 1e9)}, opt.adamw_init(cfg, params),
                                params)
    assert float(torch.linalg.norm(state["mu"]["w"])) / (1 - cfg.b1) <= 1.01


def test_update_chunks_do_not_change_the_result(monkeypatch):
    rng = np.random.default_rng(5)
    cfg = opt.AdamWConfig(lr=0.01, warmup_steps=0)
    p_np, g_np = _tree(rng, {"w": (37, 11)}), _tree(rng, {"w": (37, 11)})
    whole = opt.adamw_update(cfg, {"w": torch.from_numpy(g_np["w"])},
                             opt.adamw_init(cfg, {"w": torch.zeros(37, 11)}),
                             {"w": torch.from_numpy(p_np["w"].copy())})
    monkeypatch.setattr(opt, "UPDATE_CHUNK", 50)
    chunked = opt.adamw_update(cfg, {"w": torch.from_numpy(g_np["w"])},
                               opt.adamw_init(cfg, {"w": torch.zeros(37, 11)}),
                               {"w": torch.from_numpy(p_np["w"].copy())})
    torch.testing.assert_close(chunked[0]["w"], whole[0]["w"], rtol=0, atol=0)
    torch.testing.assert_close(chunked[1]["nu"]["w"], whole[1]["nu"]["w"], rtol=0, atol=0)


# -- checkpoint -----------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = {
        "params": {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   "h": torch.randn(4, 3).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32), "mu": [torch.ones(2)]},
        "pipeline_step": np.int64(42),
    }
    mgr.save(10, state)
    assert mgr.latest_step() == 10
    template = {"params": {"a": torch.zeros(2, 3), "h": torch.zeros(4, 3, dtype=torch.bfloat16)},
                "opt": {"step": torch.zeros((), dtype=torch.int32), "mu": [torch.zeros(2)]},
                "pipeline_step": np.int64(0)}
    step, restored = mgr.restore(template)
    assert step == 10
    assert torch.equal(restored["params"]["a"], state["params"]["a"])
    assert restored["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["h"].view(torch.int16),
                       state["params"]["h"].view(torch.int16))
    assert restored["opt"]["step"].shape == () and int(restored["opt"]["step"]) == 7
    assert torch.equal(restored["opt"]["mu"][0], torch.ones(2))
    assert int(restored["pipeline_step"]) == 42
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({**template, "params": {"a": torch.zeros(3, 2), "h": template["params"]["h"]}})
    with pytest.raises(KeyError):
        mgr.restore({"missing": torch.zeros(1)})


def test_checkpoint_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert sorted(mgr._complete()) == [3, 4]
    # A stale tmp dir from a "crash" is ignored and cleaned.
    os.makedirs(tmp_path / "ckpt_00000099.tmp123", exist_ok=True)
    assert mgr.latest_step() == 4
    mgr.save(5, state)
    assert not any(".tmp" in n for n in os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path / "ckpt_00000005")) == ["meta.json", "shard_0.npz"]


def test_checkpoint_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"x": torch.arange(4.0)}
    path = mgr.save(1, state)
    shard = os.path.join(path, "shard_0.npz")
    data = dict(np.load(shard))
    data["x"] = data["x"] + 1
    np.savez(shard, **data)
    with pytest.raises(IOError):
        mgr.restore(state)


def test_checkpoint_keys_are_the_references(tmp_path):
    """Same tree, same keys and CRCs in meta.json as the JAX manager's."""
    import json

    from repro.train.checkpoint import CheckpointManager as RefManager

    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    CheckpointManager(str(tmp_path / "port")).save(3, {"p": {"a": torch.from_numpy(a)},
                                                       "l": [torch.ones(2)], "s": np.int64(4)})
    RefManager(str(tmp_path / "ref")).save(3, {"p": {"a": jnp.asarray(a)}, "l": [jnp.ones(2)],
                                              "s": np.int64(4)})
    got, want = (json.loads((tmp_path / d / "ckpt_00000003" / "meta.json").read_text())
                 for d in ("port", "ref"))
    assert got["keys"] == want["keys"] and got["crc"] == want["crc"]


# -- trainer restart ----------------------------------------------------------


class _Tiny(torch.nn.Module):
    def __init__(self, vocab, gen):
        super().__init__()
        self.cfg = None
        self.emb = torch.nn.Parameter(torch.randn(vocab, 16, generator=gen) * 0.1)
        self.out = torch.nn.Parameter(torch.randn(16, vocab, generator=gen) * 0.1)


def _tiny_loss(model, batch):
    logits = model.emb[batch["tokens"].long()] @ model.out
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, batch["targets"].long()[..., None])[..., 0]
    return (lse - gold).mean()


def test_trainer_restart_equals_an_uninterrupted_run(tmp_path):
    vocab = 64
    pipe = TokenPipeline(vocab_size=vocab, seq_len=16, batch_per_shard=4, seed=0)
    cfg = TrainerConfig(total_steps=6, ckpt_every=3, log_every=100, ckpt_dir=str(tmp_path))

    def run():
        t = Trainer(_tiny_loss, lambda g: _Tiny(vocab, g), pipe, cfg, device="cpu")
        model, _ = t.run()
        return t, model

    t1, m1 = run()
    losses_full = [l for _, l, _ in t1.history]
    # Simulate a crash after step 3 by removing the later checkpoint.
    shutil.rmtree(tmp_path / "ckpt_00000006")
    t2, m2 = run()
    assert [s for s, _, _ in t2.history] == [3, 4, 5]
    resumed = [l for _, l, _ in t2.history]
    assert resumed == losses_full[3:]  # bit for bit on the CPU
    for name, p in m1.named_parameters():
        assert torch.equal(p, dict(m2.named_parameters())[name])


def test_train_step_microbatches_average_the_gradient():
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(32, 8, 4, seed=1).batch(
        PipelineState(0)).items()}
    cfg = opt.AdamWConfig(lr=0.01, warmup_steps=0)
    one, two = _Tiny(32, gen), _Tiny(32, gen)
    two.load_state_dict(one.state_dict())
    s1, s2 = train_state(one, cfg), train_state(two, cfg)
    l1 = train_step(one, s1, batch, 1, _tiny_loss)
    l2 = train_step(two, s2, batch, 2, _tiny_loss)
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=1e-6)
    for (_, a), (_, b) in zip(one.named_parameters(), two.named_parameters(), strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# -- launcher ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-4b", "dien"])
def test_launcher_trains_and_writes_checkpoints(tmp_path, arch, capsys):
    out = launcher.main(["--arch", arch, "--config", "smoke", "--steps", "6", "--ckpt-dir",
                         str(tmp_path / "ck"), "--device", "cpu"])
    losses = [l for _, l, _ in out["history"]]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert sorted(os.listdir(out["ckpt_dir"])) == ["ckpt_00000005"]
    # A rerun with more steps resumes from the checkpoint.
    again = launcher.main(["--arch", arch, "--steps", "7", "--ckpt-dir", str(tmp_path / "ck"),
                           "--device", "cpu"])
    assert [s for s, _, _ in again["history"]] == [5, 6]
    assert "done; checkpoints in" in capsys.readouterr().out


def test_launcher_cells_cuts_and_refusals(tmp_path):
    args = launcher.build_parser().parse_args(
        ["--arch", "gemma3-4b", "--cell", "train_4k", "--batch", "2", "--microbatches", "2",
         "--layers", "2", "--device", "cpu"])
    setup = launcher.train_setup(args)
    assert setup.cfg.remat == "full" and setup.cfg.n_layers == 2 and setup.microbatches == 2
    assert setup.pipeline.seq_len == 4096 and setup.pipeline.batch_per_shard == 2
    # The cell's optimizer is _lm_cell's; without a cell, the JAX launcher's.
    assert setup.opt_cfg == opt.AdamWConfig(moment_dtype="float32")
    smoke = launcher.train_setup(launcher.build_parser().parse_args(
        ["--arch", "gemma3-4b", "--steps", "7", "--device", "cpu"]))
    assert smoke.opt_cfg == opt.AdamWConfig(lr=1e-3, total_steps=7)
    with pytest.raises(NotImplementedError, match="not ported"):
        launcher.main(["--arch", "pna", "--steps", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="train"):
        launcher.train_setup(launcher.build_parser().parse_args(
            ["--arch", "dien", "--cell", "serve_p99", "--device", "cpu"]))
    with pytest.raises(ValueError, match="microbatches"):
        launcher.train_setup(launcher.build_parser().parse_args(
            ["--arch", "dien", "--batch", "6", "--microbatches", "4", "--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launcher.main(["--arch", "dien", "--steps", "1",
                           "--ckpt-dir", str(tmp_path / "c")])
