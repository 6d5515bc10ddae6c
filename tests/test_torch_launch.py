"""The port's launchers and data pipeline on the CPU.

``data/synthetic.py::lm_batch`` and ``data/loader.py::Prefetcher``
(test_substrate.py's determinism, host sharding and prefetch order), the
reference's own ``base``/``noise`` draws through the port's post-draw
arithmetic (``lm_tokens``: the same tokens), ``launch/train.py`` end to end
on reduced progen-s (test_integration.py's crash-resume: 6 steps, then 3
more from the checkpoint), a resumed run's weights bitwise equal to an
uninterrupted run's, what the train launcher refuses before any weight is
built, and ``python -m repro_torch.launch.serve --gateway`` in a
subprocess: it listens, answers ``/healthz``, takes a campaign, and on
SIGINT checkpoints it and stops."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.data.loader import Prefetcher  # noqa: E402
from repro_torch.data.synthetic import lm_batch, lm_tokens  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors here are small, and
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- data --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["progen-s", "rwkv6-7b"])
def test_data_determinism_and_host_sharding(arch):
    cfg = get_reduced(arch)
    b1 = lm_batch(cfg, 8, 16, seed=1, step=3, host=0, n_hosts=2)
    b2 = lm_batch(cfg, 8, 16, seed=1, step=3, host=0, n_hosts=2)
    b3 = lm_batch(cfg, 8, 16, seed=1, step=3, host=1, n_hosts=2)
    assert torch.equal(b1["inputs"], b2["inputs"])
    assert not torch.equal(b1["inputs"], b3["inputs"])
    assert b1["inputs"].shape == (4, 16)  # local shard
    assert b1["inputs"].dtype == torch.int32
    assert 0 <= int(b1["inputs"].min()) and \
        int(b1["inputs"].max()) < cfg.vocab_size
    # targets are inputs shifted by one
    assert torch.equal(b1["targets"][:, :-1], b1["inputs"][:, 1:])
    if cfg.frontend == "vision_patches":
        assert b1["patches"].shape == (4, cfg.frontend_seq, cfg.d_model)
        assert torch.equal(b1["patches"], b2["patches"])
    else:
        assert set(b1) == {"inputs", "targets"}


def test_prefetcher_order_and_close():
    it = iter(range(10))
    pf = Prefetcher(it, depth=3)
    got = [next(pf) for _ in range(10)]
    assert got == list(range(10))
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


@pytest.mark.parametrize("arch", ["progen-s", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_lm_tokens_match_reference_draws(arch):
    """The reference's ``lm_batch`` draws its ``base`` and ``noise`` from
    ``fold_in(fold_in(PRNGKey(seed), step), host)``; fed those very draws,
    the port's ``lm_tokens`` gives the reference batch's tokens exactly,
    at full vocabularies (32, 65,536, 256,000) where the int32 products
    wrap and the floor modulo maps negatives into range."""
    from repro.configs import get_config as ref_config
    from repro.data.synthetic import lm_batch as ref_batch

    cfg = ref_config(arch)
    V, B, S = cfg.vocab_size, 4, 24
    for seed, step, host in ((0, 0, 0), (3, 7, 1)):
        want = ref_batch(cfg, 2 * B, S, seed=seed, step=step, host=host,
                         n_hosts=2)
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), step), host)
        k1, k2, _ = jax.random.split(key, 3)
        base = np.asarray(jax.random.randint(k1, (B, 1), 0, V))
        noise = np.asarray(jax.random.randint(k2, (B, S + 1), 0,
                                              max(V // 64, 2)))
        toks = lm_tokens(torch.from_numpy(base.copy()),
                         torch.from_numpy(noise.copy()), V)
        assert toks.dtype == torch.int32
        np.testing.assert_array_equal(toks[:, :-1].numpy(),
                                      np.asarray(want["inputs"]))
        np.testing.assert_array_equal(toks[:, 1:].numpy(),
                                      np.asarray(want["targets"]))
        # beyond progen-s' 32 tokens, base * mult**6 leaves int32's range
        assert V < 100 or int(base.max()) * (6364136223846793005 % V) ** 6 \
            >= 2 ** 31
    assert int(jnp.asarray(want["inputs"]).max()) < V


# -- the train launcher --------------------------------------------------------


def _opt(total=12):
    return OptConfig(lr=1e-3, warmup_steps=2, total_steps=total,
                     microbatches=2)


def test_train_launcher_end_to_end(tmp_path):
    """test_integration.py's crash-resume on reduced progen-s: 6 steps with
    a checkpoint every 3, then a restore that runs the 3 steps to 9."""
    cfg = get_reduced("progen-s")
    _, _, losses = train_mod.train(cfg, _opt(), steps=6, batch=4, seq=32,
                                   ckpt_dir=str(tmp_path), ckpt_every=3,
                                   log_every=100, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all()
    _, opt_state, more = train_mod.train(cfg, _opt(), steps=9, batch=4,
                                         seq=32, ckpt_dir=str(tmp_path),
                                         restore=True, log_every=100,
                                         device="cpu")
    assert len(more) == 3  # resumed at step 6
    assert opt_state["count"] == 9


def test_resumed_run_equals_uninterrupted_run_bitwise(tmp_path):
    """On the CPU a run interrupted at step 6 and resumed to 9 ends with
    the uninterrupted 9-step run's weights, bit for bit, and repeats its
    last three losses exactly."""
    cfg = get_reduced("progen-s")
    kw = dict(batch=4, seq=32, log_every=100, device="cpu")
    train_mod.train(cfg, _opt(), steps=6, ckpt_dir=str(tmp_path),
                    ckpt_every=3, **kw)
    resumed, _, tail = train_mod.train(cfg, _opt(), steps=9,
                                       ckpt_dir=str(tmp_path), restore=True,
                                       **kw)
    whole, _, losses = train_mod.train(cfg, _opt(), steps=9, **kw)
    assert tail == losses[6:]
    a, b = resumed.state_dict(), whole.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert all(p.requires_grad for p in resumed.parameters())


@pytest.mark.parametrize("case", ["mesh sim", "softcap"])
def test_train_refuses_before_any_weight_is_built(case, monkeypatch):
    """The dense MoE form on a data-parallel mesh (its load-balance loss
    does not split over ranks) and attention with a logit softcap (no
    gradient) raise before ``lm.init_lm`` runs. A mesh is only read for
    its axes here, so a stub stands for a (2, 1) ("data", "model") one."""
    def no_weights(*a, **k):
        raise AssertionError("weights were built")
    monkeypatch.setattr(train_mod.lm, "init_lm", no_weights)
    mesh = None
    if case == "mesh sim":
        class Mesh:
            axis_names = ("data", "model")
            devices = np.empty((2, 1), dtype=object)
        cfg, mesh, match = dataclasses.replace(
            get_reduced("qwen3-moe-30b-a3b"), moe_impl="dense"), Mesh(), \
            "dense MoE"
    else:
        cfg, match = dataclasses.replace(
            get_reduced("progen-s"), attn_logit_softcap=30.0), "softcap"
    with pytest.raises(NotImplementedError, match=match):
        train_mod.train(cfg, _opt(), steps=2, batch=2, seq=8, mesh=mesh,
                        device="cpu")


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` (``main``): reduced progen-s
    on the CPU, then ``--restore`` past the saved step."""
    args = ["--arch", "progen-s", "--reduced", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train_mod.main(args + ["--steps", "2"])
    train_mod.main(args + ["--steps", "3", "--restore"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out
    assert len(re.findall(r"\[train\] done\. loss", out)) == 2


def test_train_cli_defaults_to_smollm(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train --reduced --device cpu``
    without ``--arch`` trains reduced smollm-360m, the reference's default
    (``repro/launch/train.py``), and checkpoints it."""
    seen = []

    def spy(arch):
        seen.append(arch)
        return get_reduced(arch)
    monkeypatch.setattr(train_mod, "get_reduced", spy)
    train_mod.main(["--reduced", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path)])
    assert seen == ["smollm-360m"]
    assert re.search(r"\[train\] done\. loss \d", capsys.readouterr().out)
    assert any(tmp_path.iterdir())


# -- serve --gateway -----------------------------------------------------------


def _get(base, path, body=None, method=None):
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(base + path, data=data, method=method,
                               headers={"Content-Type": "application/json",
                                        "X-Tenant": "carol"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_serve_gateway_listens_and_drains_on_sigint(tmp_path):
    """``serve --gateway --device cpu --reduced --port 0``: prints where it
    listens, answers ``/healthz``, takes a campaign over HTTP (open mode:
    the tenant from ``X-Tenant``), and on SIGINT checkpoints the live
    campaign to ``--checkpoint-dir``, prints so and exits 0. The
    checkpoint restores in the port's ``ImpressSession``."""
    from repro_torch.core.payload import ProteinPayload
    from repro_torch.gateway import GatewayService
    from repro_torch.session import ImpressSession

    ck_dir = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--gateway",
         "--device", "cpu", "--reduced", "--port", "0", "--checkpoint-dir",
         str(ck_dir)], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"\[serve\] gateway listening on (http://\S+)$",
                     line.strip())
        assert m, (line, proc.stderr.read() if proc.poll() else "")
        base = m[1]
        s, h = _get(base, "/healthz")
        assert s == 200 and h["status"] == "ok"
        assert h["devices"] == {"total": 1, "free": 1}
        s, r = _get(base, "/campaigns", {
            "structures": 1, "receptor_len": 12, "peptide_len": 4,
            "protocols": [{"kind": "im-rp", "n_cycles": 1,
                           "n_candidates": 3}]}, "POST")
        assert s == 201
        cid = r["id"]
        s, r = _get(base, f"/campaigns/{cid}/pause", {}, "POST")
        assert (s, r["state"]) == (200, "PAUSED")
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert f"[serve] checkpointed 1 live campaign(s) to {ck_dir}: " \
           f"['{cid}']" in out
    assert out.rstrip().endswith("[serve] gateway stopped")
    gw = GatewayService(payload=ProteinPayload(seed=0, reduced=True,
                                               device=CPU),
                        devices=[CPU], checkpoint_dir=str(ck_dir))
    try:
        state, tenant = gw.load_campaign_checkpoint(cid)
    finally:
        gw.shutdown()
    assert tenant == "carol" and state["schema_version"] == 1
    sess = ImpressSession.from_checkpoint(state, payload=gw.payload,
                                          devices=[CPU])
    try:
        assert sess.run(timeout=120).trajectories > 0
    finally:
        sess.shutdown()
