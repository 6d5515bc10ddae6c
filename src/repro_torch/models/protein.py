"""Protein payload models for the IMPRESS protocol.

ProGen — ProteinMPNN analogue: a structure-conditioned sequence model. The
  backbone structure is encoded as a fixed-length prefix of structure
  embeddings; the decoder emits amino-acid tokens. ``progen_sample``
  samples candidates by dense decoding (one prefill, then one decode step a
  token over each layer's dense K/V cache); ``PagedDecodeEngine`` samples
  them token by token over a paged KV cache.

FoldScore — AlphaFold analogue: predicts structure-confidence metrics for a
  (sequence, target) complex: mean pLDDT in [0,100], pTM in [0,1] and an
  inter-chain pAE in [0,30]. A fixed randomly-initialized FoldScore is a
  deterministic smooth function of the sequence: the synthetic fitness
  landscape the protocol hill-climbs.

Sampling (``sample_masked``, shared by both samplers): token ``i`` of a row
is ``argmax(logits / temperature + g_i)`` in fp32 with the pad vocabulary
masked to -1e30, where ``g_i`` is Gumbel noise (the form
``jax.random.categorical`` takes), and its log-probability is read from
``log_softmax`` of the unscaled logits. Each row draws its whole noise
block from its own ``torch.Generator``, so a row's tokens never depend on
which other rows share the batch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import blocks
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import (Dense, embed_tokens, gumbel_noise,
                                       norm_fwd, torch_dtype, weight)


class FoldMetrics(NamedTuple):
    plddt: torch.Tensor   # (B,) mean per-residue pLDDT, 0..100 (higher better)
    ptm: torch.Tensor     # (B,) 0..1 (higher better)
    pae: torch.Tensor     # (B,) inter-chain mean pAE, 0..30 (lower better)


def metrics_rows(m: FoldMetrics, n: int | None = None) -> list:
    """Batched FoldMetrics as one host-side dict per row; ``n`` truncates
    padded bucket rows."""
    plddt, ptm, pae = (t.float().cpu().tolist() for t in m)
    n = len(plddt) if n is None else n
    return [{"plddt": pl, "ptm": pt, "pae": pa}
            for pl, pt, pa in zip(plddt[:n], ptm[:n], pae[:n])]


# ---------------------------------------------------------------------------
# ProGen
# ---------------------------------------------------------------------------


class ProGen(lm_mod.LM):
    """The LM plus the structure-encoder stub ``struct_proj`` (16 -> d)."""

    def __init__(self, cfg, gen=None):
        super().__init__(cfg, gen)
        self.struct_proj = Dense((16, cfg.d_model), 16, torch.float32, gen)


def init_progen(cfg, seed=0, device="cuda"):
    """Seeded ProGen: fan-in scaled normal weights in the reference's
    shapes, drawn on the CPU (the same weights on every device)."""
    gen = torch.Generator().manual_seed(int(seed))
    return ProGen(cfg, gen).to(resolve_device(device))


def encode_structure(params, backbone, cfg):
    """backbone (B, P, 16) coarse features -> prefix embeddings (B,P,d)."""
    return (backbone.float() @ params.struct_proj.w).to(
        torch_dtype(cfg.compute_dtype))


def progen_logprobs(params, backbone, seqs, cfg, seq_lens=None):
    """Log-likelihood of sequences (B, L) given structure (B, P, 16).
    ``seq_lens`` (B,) masks per-row padding: positions >= a row's true
    length contribute nothing to its sum (the decoder is causal, so the
    valid positions score as the row alone would)."""
    patches = encode_structure(params, backbone, cfg)
    bos = torch.zeros((seqs.shape[0], 1), dtype=seqs.dtype,
                      device=seqs.device)
    inputs = torch.cat([bos, seqs[:, :-1]], dim=1)
    logits = lm_mod.lm_logits(params, {"inputs": inputs, "patches": patches},
                              cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(-1, seqs.long()[..., None])[..., 0]
    if seq_lens is None:
        return tok_lp.sum(-1)
    valid = (torch.arange(seqs.shape[1], device=seqs.device)[None, :]
             < seq_lens[:, None]).to(tok_lp.dtype)
    return (tok_lp * valid).sum(-1)


def sample_masked(logits, g, temperature, cfg):
    """logits (B, padded_vocab), Gumbel draws g (B, padded_vocab) -> (the
    token ``argmax(logits / temperature + g)`` over the real vocabulary
    (B,), its log-probability under the unscaled logits (B,) fp32). fp32
    logits are masked in place: the callers' logits are fresh."""
    logits = logits.float()
    logits[:, cfg.vocab_size:] = -1e30                   # mask pad vocab
    tok = torch.argmax(logits / temperature + g, dim=-1)
    lp = torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0]
    return tok, lp


def progen_sample(params, backbone, n, length, cfg, *, seeds=None,
                  noise=None, temperature=1.0, return_token_lps=False):
    """Sample n sequences per structure by dense decoding. backbone
    (B, P, 16), P <= ``frontend_seq``, on the device the sampling runs on.
    The prompt (patches + BOS) is prefilled into dense caches of
    ``frontend_seq + 1 + length`` slots, then ``length - 1`` decode steps
    follow, as in the reference.

    Gumbel draws (B·n, length, padded_vocab): ``noise`` when given (the
    tests feed the reference's), else backbone row b's (n, length,
    padded_vocab) block from a ``torch.Generator`` seeded ``seeds[b]`` on
    the backbone's device, so a row samples the same tokens whichever rows
    share its batch.

    Returns (seqs (B,n,L) long, loglik (B,n) fp32, summed token by token as
    the reference's scan sums it) or, with ``return_token_lps``, (seqs,
    per-token log-probs (B,n,L))."""
    B, P = backbone.shape[:2]
    if P > cfg.frontend_seq:     # the caches hold frontend_seq + 1 + length
        raise ValueError(f"backbone of {P} rows, frontend_seq is "
                         f"{cfg.frontend_seq}")
    dev = backbone.device
    shape = (n, length, cfg.padded_vocab)
    if noise is None:
        g = torch.cat([gumbel_noise(
            torch.Generator(device=dev).manual_seed(int(s)), shape, dev)
            for s in seeds])
    else:
        g = torch.as_tensor(np.asarray(noise, np.float32), device=dev) \
            .reshape(B * n, *shape[1:])
    patches = encode_structure(params, backbone.repeat_interleave(n, 0), cfg)
    bos = torch.zeros((B * n, 1), dtype=torch.long, device=dev)
    logits, caches, t0 = lm_mod.prefill(
        params, {"inputs": bos, "patches": patches}, cfg,
        cache_len=cfg.frontend_seq + 1 + length)
    tok, lp = sample_masked(logits, g[:, 0], temperature, cfg)
    toks, lps, ll = [tok], [lp], lp
    for i in range(1, length):
        logits, caches = lm_mod.decode_step(params, caches, tok[:, None],
                                            t0 + i - 1, cfg)
        tok, lp = sample_masked(logits, g[:, i], temperature, cfg)
        toks.append(tok)
        lps.append(lp)
        ll = ll + lp
    seqs = torch.stack(toks, 1).reshape(B, n, length)
    if return_token_lps:
        return seqs, torch.stack(lps, 1).reshape(B, n, length)
    return seqs, ll.reshape(B, n)


# ---------------------------------------------------------------------------
# Paged continuous-batching decode engine
# ---------------------------------------------------------------------------


class PagedDecodeEngine:
    """Continuous-batching ProGen sampler over a paged KV cache.

    A fixed number of decode slots share one pool of fixed-size K/V pages
    (``lm.init_paged_caches``); per-slot block tables and true lengths live
    on the host. Admission prefills one row's prompt into freshly popped
    pages (through the flash kernel) and samples its first token; every
    step advances all active slots through one ``lm.paged_decode_step``
    (the paged decode kernel, once per layer); retirement reads the
    finished rows out in one device->host copy, returns their pages to a
    LIFO free pool and zeroes their true lengths. Inactive slots point at a
    reserved trash page and have length 0. Rows of different lengths enter
    and leave a running batch without any shape change.

    A row's prompt is its backbone (at most ``frontend_seq`` rows) plus
    BOS, so a short backbone gives a short prompt, as in a full forward.
    (The reference engine takes every prompt to be ``frontend_seq + 1``
    long, and a shorter backbone there leaves unwritten slots inside the
    row's length.)

    ``n_admits`` and ``n_steps`` count admissions and decode steps: with the
    kernels' launch counters they show how many launches a run made.
    """

    def __init__(self, cfg, *, slots, max_new, page_size=8, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.max_new = int(max_new)
        self.page_size = int(page_size)
        self.prompt_len = cfg.frontend_seq + 1          # longest prompt
        self.pages_per_row = -(-(self.prompt_len + self.max_new - 1)
                               // self.page_size)
        self.n_pages = self.slots * self.pages_per_row
        self.trash_page = self.n_pages                  # reserved page id
        self.lock = threading.Lock()                    # one run at a time
        # host bookkeeping
        self.free_pages = list(range(self.n_pages))     # LIFO pool
        self.block_tables = np.full((self.slots, self.pages_per_row),
                                    self.trash_page, np.int32)
        self.true_lens = np.zeros(self.slots, np.int32)
        self._slot_meta = [None] * self.slots
        self._pending = deque()
        self._results = {}
        self.alloc_log = []                             # (tag, page ids)
        self.n_admits = 0
        self.n_steps = 0
        # device state, updated in place
        dev = self.device
        self.caches = lm_mod.init_paged_caches(cfg, self.n_pages + 1,
                                               self.page_size, device=dev)
        self.cur_tok = torch.zeros((self.slots, 1), dtype=torch.long,
                                   device=dev)
        self.out_toks = torch.zeros((self.slots, self.max_new),
                                    dtype=torch.long, device=dev)
        self.acc_lp = torch.zeros(self.slots, dtype=torch.float32, device=dev)
        self.noise = torch.zeros((self.slots, self.max_new, cfg.padded_vocab),
                                 dtype=torch.float32, device=dev)

    def _put(self, arr):
        # a synchronous copy into a tensor torch owns: the host arrays are
        # mutated in place right after (block tables, true lengths)
        return torch.tensor(arr, device=self.device)

    # -- host-side lifecycle ---------------------------------------------

    def submit(self, *, backbone, seed, length, tag, noise=None):
        """Queue one row: backbone (frontend_seq, 16) f32, the seed of the
        row's sampling generator, the number of tokens to sample and an
        opaque result tag. ``noise`` (>= length, padded_vocab) replaces the
        row's seeded Gumbel draws (the tests feed the reference's). Admitted
        into the running batch as soon as a slot frees up."""
        length = int(length)
        if not 1 <= length <= self.max_new:
            raise ValueError(f"length {length} outside [1, {self.max_new}]")
        if noise is not None:
            noise = np.asarray(noise, np.float32)[:self.max_new]
            if noise.shape[0] < length or \
                    noise.shape[1:] != (self.cfg.padded_vocab,):
                raise ValueError(f"noise {noise.shape} does not cover "
                                 f"({length}, {self.cfg.padded_vocab})")
        bb = np.asarray(backbone, np.float32)[:self.cfg.frontend_seq]
        self._pending.append({"backbone": bb, "seed": int(seed),
                              "length": length, "tag": tag, "noise": noise})

    def free_slots(self) -> int:
        return sum(m is None for m in self._slot_meta)

    def active_slots(self) -> int:
        return sum(m is not None for m in self._slot_meta)

    def _row_noise(self, spec):
        if spec["noise"] is None:
            gen = torch.Generator(device=self.device).manual_seed(spec["seed"])
            return gumbel_noise(gen, (self.max_new, self.cfg.padded_vocab),
                                self.device)
        noise = np.zeros((self.max_new, self.cfg.padded_vocab), np.float32)
        noise[:len(spec["noise"])] = spec["noise"]
        return self._put(noise)

    def _admit(self, spec, params, temperature):
        cfg = self.cfg
        slot = self._slot_meta.index(None)
        prompt = len(spec["backbone"]) + 1                     # patches + BOS
        need = -(-(prompt + spec["length"] - 1) // self.page_size)
        pages = [self.free_pages.pop() for _ in range(need)]
        row = np.full(self.pages_per_row, self.trash_page, np.int32)
        row[:need] = pages
        self.block_tables[slot] = row
        self.alloc_log.append((spec["tag"], tuple(pages)))
        noise = self._row_noise(spec)
        self.noise[slot] = noise
        patches = encode_structure(params, self._put(spec["backbone"][None]),
                                   cfg)
        bos = torch.zeros((1, 1), dtype=torch.long, device=self.device)
        logits, self.caches = lm_mod.paged_prefill(
            params, {"inputs": bos, "patches": patches}, cfg, self.caches,
            self._put(row[None]))
        tok0, lp0 = sample_masked(logits, noise[:1], temperature, cfg)
        self.cur_tok[slot] = tok0
        self.out_toks[slot] = 0
        self.out_toks[slot, 0] = tok0[0]
        self.acc_lp[slot] = lp0[0]
        self.true_lens[slot] = prompt
        self._slot_meta[slot] = {"tag": spec["tag"],
                                 "length": spec["length"], "done": 1}
        self.n_admits += 1
        if spec["length"] <= 1:
            self._retire(slot)

    def _retire(self, slot, out_host=None, lp_host=None):
        """Free a finished row's pages and record its result. ``out_host``
        / ``lp_host`` are host snapshots of out_toks / acc_lp, so a step
        retiring many rows pays one device->host read, not two per row."""
        meta = self._slot_meta[slot]
        if out_host is None:
            out_host = self.out_toks.cpu().numpy()
            lp_host = self.acc_lp.cpu().numpy()
        toks = np.asarray(out_host[slot, :meta["length"]], np.int32)
        ll = float(lp_host[slot])
        for pid in self.block_tables[slot]:
            if pid != self.trash_page:
                self.free_pages.append(int(pid))
        self.block_tables[slot] = self.trash_page
        self.true_lens[slot] = 0
        self._slot_meta[slot] = None
        self._results[meta["tag"]] = (toks, ll)

    def _pump(self, params, temperature):
        while self._pending and self.free_slots():
            self._admit(self._pending.popleft(), params, temperature)

    def step(self, params, temperature):
        """Advance every active slot one token; retire finished rows."""
        cfg, dev = self.cfg, self.device
        # tokens sampled so far per slot: the column of this step's token
        col = np.asarray([0 if m is None else m["done"]
                          for m in self._slot_meta], np.int32)
        host = self._put(np.concatenate(
            [self.true_lens[:, None], col[:, None], self.block_tables], 1))
        true_lens, col = host[:, 0], host[:, 1].long()
        active = true_lens > 0
        lengths = torch.where(active, true_lens + 1, 0).to(torch.int32)
        logits, self.caches = lm_mod.paged_decode_step(
            params, self.caches, self.cur_tok, true_lens,
            host[:, 2:].contiguous(), lengths, cfg)
        rows = torch.arange(self.slots, device=dev)
        nxt, step_lp = sample_masked(logits, self.noise[rows, col],
                                     temperature, cfg)
        self.out_toks[rows, col] = torch.where(active, nxt,
                                               self.out_toks[rows, col])
        self.acc_lp += torch.where(active, step_lp, 0.0)
        self.cur_tok = torch.where(active[:, None], nxt[:, None],
                                   self.cur_tok)
        self.n_steps += 1
        finished = []
        for slot, meta in enumerate(self._slot_meta):
            if meta is None:
                continue
            self.true_lens[slot] += 1
            meta["done"] += 1
            if meta["done"] >= meta["length"]:
                finished.append(slot)
        if finished:
            out_host = self.out_toks.cpu().numpy()
            lp_host = self.acc_lp.cpu().numpy()
            for slot in finished:
                self._retire(slot, out_host, lp_host)

    @torch.no_grad()
    def run(self, params, temperature, specs=(), poll=None):
        """Decode ``specs`` (plus anything ``poll`` injects) to completion.

        ``poll(free_slots) -> [spec dicts]`` is called once per loop
        iteration, the live-admission hook: rows it returns join the
        running batch at the next admission, and the engine only stops
        after a final poll comes back empty. Returns {tag: (tokens (L,)
        i32, loglik float)} for every row retired this run."""
        for s in specs:
            self.submit(**s)
        while True:
            self._pump(params, temperature)
            if poll is not None:
                new = list(poll(self.free_slots()))
                if new:
                    for s in new:
                        self.submit(**s)
                    self._pump(params, temperature)
            if not self.active_slots() and not self._pending:
                break
            if self.active_slots():
                self.step(params, temperature)
        out, self._results = self._results, {}
        return out


# ---------------------------------------------------------------------------
# FoldScore
# ---------------------------------------------------------------------------


class FoldHeads(nn.Module):
    """Confidence heads (fp32) and the target-descriptor projection."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        d, f32 = cfg.d_model, torch.float32
        self.plddt = weight(gen, (d, 1), d, f32)
        self.ptm = weight(gen, (d, 1), d, f32)
        self.pae_l = weight(gen, (d, 32), d, f32)
        self.pae_r = weight(gen, (d, 32), d, f32)
        self.tgt = weight(gen, (16, d), 16, f32)


class FoldScore(lm_mod.LM):
    def __init__(self, cfg, gen=None):
        super().__init__(cfg, gen)
        self.heads = FoldHeads(cfg, gen)


def init_foldscore(cfg, seed=0, device="cuda"):
    """Seeded FoldScore, drawn on the CPU like ``init_progen``."""
    gen = torch.Generator().manual_seed(int(seed))
    return FoldScore(cfg, gen).to(resolve_device(device))


def _foldscore_trunk(params, seqs, target, cfg):
    """Embedded complex + target descriptor through the causal stack.
    Returns final hidden states (B, L, d) in fp32. Causality means pad
    tokens appended to a row leave its real positions unchanged."""
    x = embed_tokens(params.embedding, seqs, cfg)
    # the target descriptor's projection as a sum of products a row, not a
    # (B, 16) x (16, d) GEMM: on the CPU a one-row GEMM rounds otherwise
    # than the same row among others (~1e-6), and a row's scores must not
    # depend on which rows share its batch
    tgt = (target.float()[:, :, None] * params.heads.tgt).sum(1)
    x = x + tgt[:, None].to(x.dtype)
    ctx = {"positions": torch.arange(seqs.shape[1], device=seqs.device)}
    for layer, kind in zip(params.layers, cfg.layer_kinds):
        x, _ = blocks.layer_fwd(kind, layer, x, ctx, cfg)
    return norm_fwd(params.final_norm, x, cfg).float()


def _pae_logits(params, x):
    """Full inter-residue pAE matrix (B, L, L) from trunk states."""
    h = params.heads
    zl, zr = x @ h.pae_l, x @ h.pae_r
    return 30.0 * torch.sigmoid(zl @ zr.transpose(1, 2) / np.sqrt(32.0))


def foldscore_fwd(params, seqs, target, cfg, chain_split: int):
    """seqs (B,L) int complex sequence; target (B,16) target descriptor;
    chain_split = index separating receptor from peptide chain."""
    x = _foldscore_trunk(params, seqs, target, cfg)
    h = params.heads
    plddt = (100.0 * torch.sigmoid(x @ h.plddt[:, 0])).mean(-1)
    ptm = torch.sigmoid((x @ h.ptm[:, 0]).mean(-1))
    pae_full = _pae_logits(params, x)
    pae = 0.5 * (pae_full[:, :chain_split, chain_split:].mean((-2, -1))
                 + pae_full[:, chain_split:, :chain_split].mean((-2, -1)))
    return FoldMetrics(plddt=plddt, ptm=ptm, pae=pae)


def foldscore_fwd_masked(params, seqs, target, seq_lens, chain_splits, cfg):
    """Masked scorer for dense mixed-length batches: seqs (B, Lpad) padded
    past each row's true length ``seq_lens`` (B,); ``chain_splits`` (B,)
    per-row receptor length. Pad positions are excluded from the pLDDT/pTM
    means and both inter-chain pAE means, so a padded row scores as it
    would alone at its true length."""
    x = _foldscore_trunk(params, seqs, target, cfg)
    h = params.heads
    pos = torch.arange(seqs.shape[1], device=seqs.device)[None, :]
    valid = (pos < seq_lens[:, None]).float()
    n_valid = valid.sum(-1).clamp_min(1.0)
    plddt_res = 100.0 * torch.sigmoid(x @ h.plddt[:, 0])
    plddt = (plddt_res * valid).sum(-1) / n_valid
    ptm = torch.sigmoid(((x @ h.ptm[:, 0]) * valid).sum(-1) / n_valid)
    pae_full = _pae_logits(params, x)
    receptor = (pos < chain_splits[:, None]).float()
    peptide = valid * (1.0 - receptor)
    den = (receptor.sum(-1) * peptide.sum(-1)).clamp_min(1.0)
    rp = torch.einsum("bij,bi,bj->b", pae_full, receptor, peptide) / den
    pr = torch.einsum("bij,bi,bj->b", pae_full, peptide, receptor) / den
    return FoldMetrics(plddt=plddt, ptm=ptm, pae=0.5 * (rp + pr))
