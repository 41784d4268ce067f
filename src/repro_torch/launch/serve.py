"""Serving launcher: batched prefill + greedy decode with a KV page table
whose pages are claimed NOWAIT-style (port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --no-reduced --batch 4 --prompt-len 2048

Admission claims each request's KV pages in a lock-word page table (one
compare-and-swap per page; any conflict releases the claim and retries
with another page set, RCC's NOWAIT policy); then the LM prefills the
prompts and decodes greedily from the cache; then the pages are released.
Weights come from ``init_lm`` at the seed and prompts from
``randint(PRNGKey(seed + 1))``, the reference's draws (seed 0 gives its
``PRNGKey(0)`` weights and ``PRNGKey(1)`` prompts).  Runs on ``"cuda"``
unless ``device="cpu"`` is given.

An SSM model (``--arch falcon-mamba-7b``) has no attention, so the
``"kernel"`` and ``"torch"`` planes compute the same thing for it, and its
cache is a per-layer state, not KV pages: admission claims the pages as
for any model, and they never reach the model, as in the reference.  So
for the hybrid (``--arch recurrentgemma-2b``): its attention is local,
which no kernel takes, so both planes compute the same thing too, and its
cache holds each RG-LRU layer's state and each attention layer's ring of
its window's W slots, token p at slot p mod W.

An encoder-decoder (``--arch whisper-small``) also takes each request's
audio window: ``enc_seq_len`` frame embeddings from the reference's stub
frontend, drawn as the reference's serve draws them, with
``normal(PRNGKey(seed + 1))``, the prompts' key.  Prefill encodes them (the
``flash_attention`` kernel, not causal, once per encoder layer on the
``"kernel"`` plane) and caches each decoder layer's cross k/v; each decode
step attends to all of them.

    python -m repro_torch.launch.serve --arch whisper-small --no-reduced --batch 4 --prompt-len 224 --gen-len 224

An M-RoPE model (``--arch qwen2-vl-72b``) takes three position ids a token
(temporal, height, width).  Text-only prompts take the reference's: 0..P-1
for each id in prefill, then P + i for each in decode step i.  With
``image=(offset, (t, h, w))`` every prompt holds one image grid of t*h*w
vision tokens from ``offset`` on (``vlm_layout``): the reference's vision
stub has no encoder, so they are a reserved id, the vocabulary's last, at
Qwen2-VL's multimodal positions, and decode's positions run on from the
largest id + 1, behind the cache length.

    python -m repro_torch.launch.serve --arch qwen2-vl-72b --no-reduced --layers 12 --batch 4 --prompt-len 2048
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models.decode import lm_decode_step, lm_prefill
from repro_torch.models.lm import LM, init_lm, resolve_device


class PageTable:
    """KV page allocator over lock words: a page is free iff its word is 0.

    ``alloc`` is a NOWAIT transaction: it reads the lock words, draws n of
    the pages that read free in a random order from the port's threefry
    (``prng``), claims every page iff all are still free (one compare-and-
    swap each), and on any conflict draws again (at most 8 attempts).  The
    reference draws its candidates from all pages (``jax.random.choice``), so
    a request conflicts almost surely once the table is partly claimed (at
    the full config, 131 pages of 2096 per request: the second request's
    draw finds a free set with probability about 2e-4), and its page ids
    differ; they never reach the model.
    """

    def __init__(self, n_pages: int, device=None):
        self.locks = torch.zeros((n_pages,), dtype=torch.int32, device=device)
        self.n_pages = n_pages

    def _choice(self, key, n: int) -> torch.Tensor:
        """n distinct pages, those that read free first, each group in an
        order sorted by random bits."""
        bits = prng.random_bits(key.to(self.locks.device), (self.n_pages,))
        taken = (self.locks != 0).long() << 32  # the bits are below 2**32
        return torch.argsort(bits + taken, stable=True)[:n]

    def alloc(self, n: int, owner: int, key) -> torch.Tensor:
        if n > self.n_pages:
            raise ValueError(f"cannot claim {n} distinct pages of {self.n_pages}")
        for attempt in range(8):
            cand = self._choice(prng.fold_in(key, attempt), n)
            if bool((self.locks[cand] == 0).all()):
                self.locks[cand] = owner + 1
                return cand
        raise RuntimeError("page table exhausted")

    def free(self, pages: torch.Tensor):
        self.locks[pages] = 0

    @property
    def used(self) -> int:
        return int((self.locks != 0).sum())


@dataclass
class ServeResult:
    tokens: torch.Tensor  # (B, G) greedy tokens; step 0 from the prefill
    logits: torch.Tensor  # (G, B, V) float logits each token was picked from
    prompts: torch.Tensor  # (B, P)
    prefill_ms: float  # wall time of the prefill, synchronised
    decode_ms_per_step: float  # wall time per decode step (G - 1 steps)
    tokens_per_s: float  # decoded tokens per second of decode wall time
    pages_used: int  # after admission
    pages_total: int
    pages_used_after_release: int
    plane: str
    frames: Optional[torch.Tensor] = None  # (B, enc_seq_len, D) an encoder-decoder's audio frames
    positions: Optional[torch.Tensor] = None  # (B, 3, P) an M-RoPE model's prompt position ids


def vlm_layout(prompt_len: int, image=None, device=None):
    """A prompt's M-RoPE layout as Qwen2-VL's ``get_rope_index`` makes it:
    (position ids (3, P) int32, the image's token mask (P,), the first
    position id after the prompt).  Text tokens take one id for all three
    (0, 1, ... from the prompt's start, or from the largest id before them
    + 1); an image ``(offset, (t, h, w))`` of t*h*w tokens from ``offset``
    on, row-major, takes (s + frame, s + row, s + col) for the start s that
    text at ``offset`` would take.  Without an image: 0..P-1 three times."""
    ids = torch.arange(prompt_len, dtype=torch.int32, device=device).expand(3, prompt_len).clone()
    mask = torch.zeros(prompt_len, dtype=torch.bool, device=device)
    if image is None:
        return ids, mask, prompt_len
    offset, (t, h, w) = image
    n = t * h * w
    if offset < 0 or offset + n > prompt_len:
        raise ValueError(f"an image of {t}x{h}x{w} tokens at {offset} does not fit a {prompt_len}-token prompt")
    grid = torch.stack(torch.meshgrid(*(torch.arange(k, dtype=torch.int32, device=device) for k in (t, h, w)),
                                      indexing="ij")).reshape(3, n)
    ids[:, offset:offset + n] = offset + grid
    after = offset + max(t, h, w)  # the largest id of the image + 1
    ids[:, offset + n:] = torch.arange(after, after + prompt_len - offset - n, dtype=torch.int32, device=device)
    mask[offset:offset + n] = True
    return ids, mask, after + prompt_len - offset - n


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def serve(cfg: ArchConfig, *, batch: int = 4, prompt_len: int = 32, gen_len: int = 32, page_size: int = 16,
          seed: int = 0, device="cuda", plane: str = ops.AUTO, dtype=torch.float32, params: LM = None,
          image=None, verbose: bool = False) -> ServeResult:
    """Admission -> prefill -> greedy decode -> release for ``batch``
    random prompts of ``prompt_len`` tokens, ``gen_len`` tokens each.

    ``params`` reuses weights built earlier (``init_lm`` at the same seed
    and dtype); otherwise they are drawn here, on ``device``.  ``image``
    ``(offset, (t, h, w))`` puts one image grid in every prompt of an
    M-RoPE model (``vlm_layout``)."""
    dev = resolve_device(device)
    plane = ops.resolve_plane(plane, dev)
    log = print if verbose else (lambda *a: None)
    if params is None:
        params = init_lm(prng.prng_key(seed), cfg, dtype, device=dev)
    log(f"[serve] arch={cfg.name} params={cfg.param_count():,} device={dev} plane={plane}")

    B, P, G = batch, prompt_len, gen_len
    total = P + G
    per_request = total // page_size + 1
    pt = PageTable(n_pages=4 * B * per_request, device=dev)
    pages = {b: pt.alloc(per_request, b, prng.prng_key(seed + 100 + b, dev)) for b in range(B)}
    used = pt.used
    log(f"[serve] admitted {B} requests; page table used={used}/{pt.n_pages}")

    prompts = prng.randint(prng.prng_key(seed + 1, dev), (B, P), 0, cfg.vocab_size)
    batch = {"tokens": prompts}
    if cfg.encoder_decoder:
        batch["frames"] = prng.normal(prng.prng_key(seed + 1, dev), (B, cfg.enc_seq_len, cfg.d_model)).to(dtype)
    if image is not None and cfg.mrope_sections is None:
        raise ValueError(f"{cfg.name} has no M-RoPE: it takes no image")
    if cfg.mrope_sections is not None:
        ids, mask, next_id = vlm_layout(P, image, dev)
        prompts = batch["tokens"] = prompts.masked_fill(mask, cfg.vocab_size - 1)
        batch["positions"] = ids.expand(B, 3, P)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm_prefill(params, cfg, batch, pad_to=total, plane=plane)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    log(f"[serve] prefill {B}x{P} in {prefill_ms:.3f} ms")

    tok = logits.argmax(-1)
    out, steps = [tok], [logits.float()]
    t0 = time.perf_counter()
    for i in range(G - 1):
        step = {"token": tok}
        if cfg.mrope_sections is not None:
            step["positions"] = torch.full((B, 3), next_id + i, dtype=torch.int32, device=dev)
        logits, cache = lm_decode_step(params, cfg, cache, step)
        tok = logits.argmax(-1)
        out.append(tok)
        steps.append(logits.float())
    _sync(dev)
    decode_s = time.perf_counter() - t0
    n_tok = B * (G - 1)
    step_ms = decode_s * 1e3 / max(G - 1, 1)
    tok_s = n_tok / decode_s if decode_s > 0 else float("nan")
    log(f"[serve] decoded {n_tok} tokens in {decode_s * 1e3:.3f} ms ({step_ms:.3f} ms/step, {tok_s:.1f} tok/s)")
    for b in range(B):
        pt.free(pages[b])
    log(f"[serve] released pages; page table used={pt.used}")
    seq = torch.stack(out, 1)
    step_logits = torch.stack(steps)
    if not bool(torch.isfinite(step_logits).all()) or seq.shape != (B, G):
        raise AssertionError("serve: non-finite logits or a wrong token shape")
    return ServeResult(seq, step_logits, prompts, prefill_ms, step_ms, tok_s, used, pt.n_pages, pt.used, plane,
                       batch.get("frames"), batch.get("positions"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="the tiny same-family config (default); --no-reduced serves the full config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers at full width (qwen2-vl-72b: 12 of 80 fit "
                         "one 80 GB card in float32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plane", default=ops.AUTO, choices=(ops.AUTO,) + ops.KERNEL_PLANES)
    args = ap.parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)[0]
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen_len=args.gen_len, page_size=args.page_size,
          seed=args.seed, device=args.device, plane=args.plane, verbose=True)
    print("[serve] ok")


if __name__ == "__main__":
    main()
