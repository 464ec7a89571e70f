"""Decoder LM of the serve and train paths (port of repro.models.model):
the attention families -- dense, moe, audio and vlm -- with the attention
variants (QKV bias, qk-norm, tied embeddings, sliding windows, local/global
layers and both soft-caps), the recurrent ``ssm`` family (xLSTM: mLSTM /
sLSTM pairs, ``models/xlstm.py``) and the ``hybrid`` one (Zamba2: a Mamba2
backbone, ``models/mamba2.py``, with one shared attention block applied
after every ``shared_attn_every - 1`` Mamba layers).

Parameters are a dict: ``embed`` (V, d) bf16, ``final_norm`` (d,) f32,
``lm_head`` (d, V) bf16 (absent under ``tie_embeddings``: the head is
``embed.T``) and ``layers``, a list of per-layer dicts
``{attn_norm, attn: {wq, wk, wv, wo[, bq, bk, bv][, q_norm, k_norm]},
ffn_norm, ffn}``: ``ffn`` is ``{gate, up, down}`` (an MLP), or under
``cfg.is_moe`` ``{router, gate, up, down}`` (``models/moe.py``). A model
with ``input_mode="embeddings"`` (the audio and vlm families, whose
frontends are stubs in the reference) takes its input as embeddings; it
still draws ``embed``, as the reference's ``init_params`` does.
The recurrent families have no ``layers``: an ``ssm`` model holds, per
pair of blocks, ``mlstm`` (``xlstm.init_mlstm``), ``mlstm_norm`` (d,) f32,
``slstm`` and ``slstm_norm``; a ``hybrid`` one ``mamba``
(``mamba2.init_mamba2``) and ``mamba_norm`` per Mamba layer and one
``shared_attn`` block (an attention layer's dict), whose single weight set
every application uses.
The reference stacks the layers (and the recurrent blocks) on a leading
axis and scans over them; the port loops over a list, so each block can be
packed and freed on its own (``repro_torch.convert`` maps one layout to
the other).

Entry points:
  forward(...)        logits of whole sequences (training), no caches
  loss_fn(...)        next-token cross-entropy of ``forward``'s logits
  decode_step(...)    one token per slot against the per-slot caches
  prefill_chunk(...)  up to T tokens per slot in one launch, bit-identical
                      per position to feeding them through decode_step
                      (attention families only: a recurrent state takes
                      one token at a time, as in the reference)
The last two update the caches in place (a recurrent block's cache dict
gets its new tensors); all return f32 logits.
``forward`` and ``loss_fn`` are differentiable (autograd) under ``quant``
``none`` and ``qat``; under ``serve`` they run the packed GEMMs.

Tensor parallelism (ROADMAP A13, A13b; ``repro_torch.distributed.tp``):
with placed parameters under ``use_sharding`` every family computes on
each rank's weight shards, the activations carrying the reference's
``constrain`` annotations: the embedding is looked up in this rank's
vocabulary rows and summed over "model" (each token's row is on one
rank), the blocks run their products on the shards (``models/quant.py``,
``attention.py``, ``moe.py``; the recurrent blocks of ``xlstm.py`` and
``mamba2.py`` run their cells on this rank's heads against head-sharded
states), the head is column-parallel over the vocabulary, and the entry
points return the whole logits on every rank.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import envflags
from repro_torch.core.codecs import get_codec, packed_codecs
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import constrain
from . import attention as attn
from . import mamba2 as mb
from . import xlstm as xl
from .kvquant import kv_codec
from .layers import init_embedding, init_mlp, mlp_apply, rms_norm, softcap
from .moe import init_moe, moe_apply
from .numerics import dot_f32acc
from .quant import pack_serving_weight

__all__ = [
    "init_params", "init_head", "init_layer", "init_blocks", "build_params",
    "init_caches",
    "forward", "loss_fn", "decode_step", "prefill_chunk",
    "pack_layer_for_serving", "pack_params_for_serving", "layer_windows",
    "hybrid_segments", "RECURRENT",
]

# the reference's names of the GEMM weights that serving packs
# (model.py's _PACK_KEYS; its _SKIP_KEYS -- router, conv, A_log, D,
# dt_bias, norms, b_if, w_if, r, b, gn, embed, lm_head -- are not in it)
_PACK_KEYS = ("wq", "wk", "wv", "wo", "gate", "up", "down", "in_proj",
              "out_proj", "w", "ff_up", "ff_down", "w_o")
# the per-head block-diagonal cell projections of an mLSTM stay bf16
_MLSTM_DENSE = ("wq", "wk", "wv")
# cache (and parameter) groups that hold recurrent state
RECURRENT = ("mlstm", "slstm", "mamba")


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a served ``quant_format`` with no packed
    path (naming ``packed_codecs()``) or a ``kv_quant`` codec with no
    packed KV path (naming ``kv_codecs()``), in the reference's words.
    Every family of the reference is served."""
    if cfg.quant == "serve" and not get_codec(cfg.quant_format).packed:
        raise ValueError(
            f"cfg.quant_format={cfg.quant_format!r} has no packed serving "
            f"path; packable codecs: {', '.join(packed_codecs())}")
    if cfg.kv_quant != "none":
        kv_codec(cfg.kv_quant)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_head(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Embedding, final norm and LM head (drawn before the layers); no
    ``lm_head`` under ``tie_embeddings``."""
    check_supported(cfg)
    out = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        device).T.contiguous()
    return out


def init_layer(gen: torch.Generator, cfg, device="cuda") -> dict:
    ones = torch.ones(cfg.d_model, dtype=torch.float32, device=device)
    return {
        "attn_norm": ones,
        "attn": attn.init_attention(gen, cfg, device),
        "ffn_norm": ones.clone(),
        "ffn": init_moe(gen, cfg, device) if cfg.is_moe
        else init_mlp(gen, cfg.d_model, cfg.d_ff, device),
    }


def _n_mamba(cfg) -> int:
    """Mamba layers of a hybrid model: its ``mamba`` kinds (the
    reference's count)."""
    return sum(1 for k in cfg.kinds if k == "mamba")


def init_blocks(gen: torch.Generator, cfg, device="cuda"):
    """(group, block) in draw order, after the head: ("layers", layer)
    per attention layer; per xLSTM pair ("mlstm", ...), ("mlstm_norm",
    (d,) ones), ("slstm", ...), ("slstm_norm", ...); per Mamba layer
    ("mamba", ...), ("mamba_norm", ...), then ("shared_attn", layer)
    once."""
    def ones():
        return torch.ones(cfg.d_model, dtype=torch.float32, device=device)
    if cfg.family == "ssm":
        for _ in range(cfg.n_layers // 2):
            yield "mlstm", xl.init_mlstm(gen, cfg, device)
            yield "mlstm_norm", ones()
            yield "slstm", xl.init_slstm(gen, cfg, device)
            yield "slstm_norm", ones()
    elif cfg.family == "hybrid":
        for _ in range(_n_mamba(cfg)):
            yield "mamba", mb.init_mamba2(gen, cfg, device)
            yield "mamba_norm", ones()
        yield "shared_attn", init_layer(gen, cfg, device)
    else:
        for _ in range(cfg.n_layers):
            yield "layers", init_layer(gen, cfg, device)


# the groups of blocks that the reference stacks, per family
_GROUPS = {"ssm": ("mlstm", "mlstm_norm", "slstm", "slstm_norm"),
           "hybrid": ("mamba", "mamba_norm")}


def build_params(gen: torch.Generator, cfg, device="cuda",
                 convert=None) -> dict:
    """The head, then each of ``init_blocks``' blocks passed through
    ``convert(group, block)`` (default: kept as drawn) into its place: its
    group's list (empty lists for a model of no blocks), or
    ``shared_attn`` itself."""
    params = init_head(gen, cfg, device)
    params.update({g: [] for g in _GROUPS.get(cfg.family, ("layers",))})
    for group, block in init_blocks(gen, cfg, device):
        if convert is not None:
            block = convert(group, block)
        if group == "shared_attn":
            params[group] = block
        else:
            params[group].append(block)
    return params


def init_params(gen: torch.Generator, cfg, device="cuda") -> dict:
    """Random dense bf16 parameters drawn from ``gen`` (a generator on
    ``device``). The draws differ from the reference's ``jax.random``."""
    return build_params(gen, cfg, device)


def layer_windows(cfg) -> list:
    """Each layer's window as a plain int, 0 for a global layer (the
    reference's values): under ``local_global`` the even layers are local
    with ``sliding_window or 4096``; with ``sliding_window`` alone every
    layer is windowed; else all are global."""
    if cfg.local_global:
        local = cfg.sliding_window or 4096
        return [local if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.sliding_window or 0] * cfg.n_layers


def hybrid_segments(cfg) -> tuple:
    """Zamba2's layout: every ``shared_attn_every``-th block is the shared
    attention block. Returns (applications of it, Mamba layers before each,
    trailing Mamba layers)."""
    every = cfg.shared_attn_every
    n_attn = cfg.n_layers // every
    seg = every - 1
    trailing = cfg.n_layers - n_attn - n_attn * seg
    return n_attn, seg, trailing


def init_caches(cfg, batch: int, max_len: int, device="cuda") -> dict:
    """Per-slot caches, the slot on axis 0 of every tensor. Attention
    families: the KV cache of every layer (``attention.init_cache``), each
    a ring of ``min(window, max_len)`` positions for its layer's window:
    bf16, or packed in ``cfg.kv_quant``; the reference's local/global
    stacks are this list's even and odd layers. ``ssm``: {"mlstm": [...],
    "slstm": [...]}, a recurrent state per pair. ``hybrid``: {"mamba":
    [...] per Mamba layer, "attn": [...] a global KV cache per
    application of the shared block}."""
    check_supported(cfg)
    if cfg.family == "ssm":
        n_pairs = cfg.n_layers // 2
        return {"mlstm": [xl.init_mlstm_cache(cfg, batch, device)
                          for _ in range(n_pairs)],
                "slstm": [xl.init_slstm_cache(cfg, batch, device)
                          for _ in range(n_pairs)]}
    if cfg.family == "hybrid":
        n_seg, seg, trailing = hybrid_segments(cfg)
        return {"mamba": [mb.init_mamba2_cache(cfg, batch, device)
                          for _ in range(n_seg * seg + trailing)],
                "attn": [attn.init_cache(cfg, batch, max_len, 0, device)
                         for _ in range(n_seg)]}
    return {"layers": [attn.init_cache(cfg, batch, max_len, w, device)
                       for w in layer_windows(cfg)]}


# ---------------------------------------------------------------------------
# Decode / chunked prefill
# ---------------------------------------------------------------------------

class _EmbedLookup(torch.autograd.Function):
    """``table[tokens]`` whose gradient is the one-hot product
    ``onehot(tokens)^T @ g`` (``dot_f32acc``: exact products, summed in
    f32 or wider, rounded once to the table's dtype), so repeated tokens
    sum in a fixed order; an indexing backward would sum them with atomics
    on the card, in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        onehot = torch.nn.functional.one_hot(tokens.reshape(-1).long(),
                                             ctx.vocab).to(g2.dtype)
        return dot_f32acc(onehot.T, g2).to(ctx.dtype), None


def _embed_in(params, cfg, batch) -> torch.Tensor:
    """batch {"embeds": (B, T, d) bf16} under ``input_mode="embeddings"``,
    else {"tokens": (B, T)} looked up in ``embed``."""
    if cfg.input_mode == "embeddings":
        h = batch["embeds"]
        if tp.is_dtensor(params["embed"]):
            h = tp.wrap(h, tp.replicate())
        return constrain(h, ("batch", "seq", "embed"))
    table = params["embed"]
    if tp.is_dtensor(table):
        h = _embed_tp(table, batch["tokens"])
        return constrain(h, ("batch", "seq", "embed"))
    return _lookup(table, batch["tokens"])


def _lookup(table, tokens):
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbedLookup.apply(table, tokens)
    return table[tokens]


def _embed_tp(table, tokens):
    """Vocabulary-parallel lookup: this rank's rows of the table (its
    shard along "model", gathered along "fsdp") give the tokens they hold
    and zeros elsewhere, a Partial sum over "model" that the caller's
    ``constrain`` reduces: one rank holds each token's row, so the sum is
    that row (a -0.0 entry comes back +0.0). A table replicated over
    "model" is looked up whole."""
    from torch.distributed.tensor import Partial
    local = tp.model_local(table)
    if not tp.model_placement(table).is_shard():
        return tp.wrap(_lookup(local, tokens), tp.replicate())
    n = local.shape[0]
    idx = tokens - tp.tp_rank() * n
    inside = (idx >= 0) & (idx < n)
    rows = _lookup(local, idx.clamp(0, n - 1))
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return tp.wrap(rows, Partial())


def _ffn(lp, h, cfg):
    x = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    if cfg.is_moe:
        return h + moe_apply(lp["ffn"], x, cfg, cfg.quant)
    return h + mlp_apply(lp["ffn"], x, cfg.quant, cfg.quant_format)


def _logits(params, cfg, h):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if tp.is_dtensor(h):
        return _logits_tp(params, cfg, h)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(dot_f32acc(h, head), cfg.final_softcap)


def _logits_tp(params, cfg, h):
    """The head on this rank's vocabulary columns (``embed``'s rows under
    ``tie_embeddings``): column-parallel, soft-capped, constrained to the
    reference's ("batch", "seq", "vocab"); gathered whole by the entry
    points."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    vocab_dim = 0 if cfg.tie_embeddings else 1
    local = tp.model_local(table)
    head = local.T if cfg.tie_embeddings else local
    placement = tp.model_placement(table)
    if placement.is_shard() and placement.dim == vocab_dim:
        logits = tp.column(h, lambda x: dot_f32acc(x, head), head.shape)
    else:
        logits = tp.replicated(h, lambda x: dot_f32acc(x, head), head.shape)
    logits = softcap(logits, cfg.final_softcap)
    return constrain(logits, ("batch", "seq", "vocab"))


def _attn_block_forward(lp, h, cfg, positions, window: int):
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    out, kv = attn.attention_forward(lp["attn"], x, cfg, positions,
                                     cfg.quant, window)
    h = constrain(_ffn(lp, h + out, cfg), ("batch", "seq_sp", "embed"))
    return h, kv


def _attn_block_decode(lp, h, cfg, cache, index, window: int):
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    h = h + attn.attention_decode(lp["attn"], x, cfg, cache, index,
                                  cfg.quant, window)
    return _ffn(lp, h, cfg)


# the aten products each REPRO_REMAT_POLICY keeps: ``dots`` every matrix
# product (JAX's checkpoint_dots), ``dots_no_batch`` those without a batch
# axis (dots_with_no_batch_dims_saveable): the weight projections and the
# head, not attention's or the experts' batched einsums. The products are
# reached through numerics.dot_f32acc / einsum_f32acc: ``mm`` / ``bmm``
# (float64 on the CPU, out_dtype f32 or IEEE f32 on the card), inside
# _CardProduct's forward too.
_REMAT_KEEP = {
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _remat_context(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` that keeps
    the outputs of ``_REMAT_KEEP[policy]``'s products and recomputes the
    rest in the backward."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    keep = {getattr(torch.ops.aten, n) for n in _REMAT_KEEP[policy]}

    def choose(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op.overloadpacket in keep \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(choose)


def _remat(cfg, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward under
    ``cfg.remat``, with the reference's ``REPRO_REMAT_POLICY``: ``none``
    keeps only the inputs; ``dots`` and ``dots_no_batch`` also keep the
    outputs of the products ``_REMAT_KEEP`` names (a kept output has the
    bits the recomputation would give, so the gradients are those of
    ``none``)."""
    if not cfg.remat:
        return fn(*args)
    policy = envflags.get_str("REPRO_REMAT_POLICY")
    if policy == "none":
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: _remat_context(policy))


def _block(forward_fn, p, norm, h, cfg):
    """Pre-norm residual recurrent block: h + block(rms_norm(h))."""
    out, _ = forward_fn(p, rms_norm(h, norm, cfg.norm_eps), cfg, cfg.quant)
    return h + out


def _pair_forward(pm, pnm, ps, pns, h, cfg):
    h = _block(xl.mlstm_forward, pm, pnm, h, cfg)
    return _block(xl.slstm_forward, ps, pns, h, cfg)


def _ssm_forward(params, cfg, h):
    for pm, pnm, ps, pns in zip(params["mlstm"], params["mlstm_norm"],
                                params["slstm"], params["slstm_norm"]):
        h = _remat(cfg, _pair_forward, pm, pnm, ps, pns, h, cfg)
    return h


def _application_after(cfg, i: int):
    """The application of the shared attention block (the index of its KV
    cache) that follows Mamba layer ``i``, or None."""
    n_seg, seg, _ = hybrid_segments(cfg)
    return i // seg if i < n_seg * seg and i % seg == seg - 1 else None


def _hybrid_forward(params, cfg, h, positions):
    sa = params["shared_attn"]
    for i, (pm, pn) in enumerate(zip(params["mamba"], params["mamba_norm"])):
        h = _remat(cfg, _block, mb.mamba2_forward, pm, pn, h, cfg)
        if _application_after(cfg, i) is not None:
            h = _remat(cfg, _attn_block_forward, sa, h, cfg, positions,
                       0)[0]
    return h


def forward(params: dict, cfg, batch: dict, collect_cache: bool = False):
    """Logits of whole sequences (training; the reference's ``forward``
    for the attention families). batch: {"tokens": (B, S)} or
    {"embeds": (B, S, d)}, optionally "positions" (B, S) (else 0..S-1).
    Returns f32 logits (B, S, V); with ``collect_cache`` also each layer's
    (k, v), (B, S, nkv, hd). Under ``cfg.remat`` each layer's activations
    are recomputed in the backward (``torch.utils.checkpoint``, the
    reference's default policy: only the layers' inputs are kept). The
    recurrent families return the logits alone (no KV cache), as the
    reference does, and take a sequence of at most 128 positions or a
    multiple of 128 (``ValueError`` otherwise)."""
    check_supported(cfg)
    h = _embed_in(params, cfg, batch)
    b, s = h.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=h.device).expand(b, s)
    if cfg.family == "ssm":
        return tp.full(_logits(params, cfg, _ssm_forward(params, cfg, h)))
    if cfg.family == "hybrid":
        return tp.full(_logits(params, cfg,
                               _hybrid_forward(params, cfg, h, positions)))
    kvs = []
    for lp, window in zip(params["layers"], layer_windows(cfg)):
        h, kv = _remat(cfg, _attn_block_forward, lp, h, cfg, positions,
                       window)
        if collect_cache:
            kvs.append(tuple(tp.full(a) for a in kv))
    logits = tp.full(_logits(params, cfg, h))
    return (logits, kvs) if collect_cache else logits


def loss_fn(params: dict, cfg, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy of ``forward`` (labels ``batch["labels"]``,
    negatives ignored), as the reference writes it: logsumexp minus a
    masked one-hot reduce over the vocabulary (not a gather), summed over
    the valid positions and divided by their count (at least 1)."""
    logits = forward(params, cfg, batch)
    labels = batch["labels"]
    valid = labels >= 0
    safe = labels.clamp_min(0)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    vocab = torch.arange(lf.shape[-1], dtype=labels.dtype,
                         device=labels.device)
    picked = torch.where(safe[..., None] == vocab, lf, 0.0).sum(dim=-1)
    nll = lse - picked
    return (nll * valid).sum() / valid.sum().clamp_min(1)


def decode_step(params: dict, cfg, batch: dict, caches: dict,
                index: torch.Tensor) -> torch.Tensor:
    """One token for every slot. batch: {"tokens": (B, 1)}, or
    {"embeds": (B, 1, d)} under ``input_mode="embeddings"``; ``index`` (B,)
    absolute position of each slot's token. Updates ``caches`` in place and
    returns f32 logits (B, 1, V)."""
    h = _embed_in(params, cfg, batch)
    if cfg.family == "ssm":
        h = _ssm_decode(params, cfg, h, caches)
    elif cfg.family == "hybrid":
        h = _hybrid_decode(params, cfg, h, caches, index)
    else:
        for lp, cache, window in zip(params["layers"], caches["layers"],
                                     layer_windows(cfg)):
            h = _attn_block_decode(lp, h, cfg, cache, index, window)
    return tp.full(_logits(params, cfg, h))


def _block_decode(decode_fn, p, norm, h, cfg, cache):
    """Pre-norm residual recurrent block, one token; ``cache`` (a dict)
    takes the new state."""
    out, new = decode_fn(p, rms_norm(h, norm, cfg.norm_eps), cfg, cache,
                         cfg.quant)
    cache.update(new)
    return h + out


def _ssm_decode(params, cfg, h, caches):
    for pm, pnm, ps, pns, cm, cs in zip(
            params["mlstm"], params["mlstm_norm"], params["slstm"],
            params["slstm_norm"], caches["mlstm"], caches["slstm"]):
        h = _block_decode(xl.mlstm_decode, pm, pnm, h, cfg, cm)
        h = _block_decode(xl.slstm_decode, ps, pns, h, cfg, cs)
    return h


def _hybrid_decode(params, cfg, h, caches, index):
    """The Mamba layers in order with their caches, the shared block after
    each segment (its own KV cache per application), then the trailing
    Mamba layers."""
    sa = params["shared_attn"]
    mamba = zip(params["mamba"], params["mamba_norm"], caches["mamba"])
    for i, (pm, pn, c) in enumerate(mamba):
        h = _block_decode(mb.mamba2_decode, pm, pn, h, cfg, c)
        a = _application_after(cfg, i)
        if a is not None:
            h = _attn_block_decode(sa, h, cfg, caches["attn"][a], index, 0)
    return h


def prefill_chunk(params: dict, cfg, batch: dict, caches: dict,
                  index: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Chunked prefill: batch {"tokens": (B, T)} (or {"embeds": (B, T, d)});
    ``index`` (B,) position of column 0 per slot; ``lengths`` (B,) valid
    tokens per row, 0..T (0 = idle, caches untouched). Every projection
    runs once over the chunk. Returns f32 logits (B, T, V); ``logits[b, t]``
    for t < lengths[b] is bit-identical to what ``decode_step`` emits for
    the same tokens fed one at a time, later positions are garbage to
    discard -- except under ``cfg.is_moe``, as in the reference: the
    experts route the chunk's B*T tokens (its padding included) as one
    group, whose capacity differs from that of the B tokens of a decode
    step, so a chunk of T > 1 may drop other tokens than decode does.

    The recurrent families raise ``NotImplementedError``, as the
    reference does: their state takes one token at a time (the engine
    runs them with chunks of 1)."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"chunked prefill needs attention caches; family "
            f"{cfg.family!r} decodes one token at a time")
    h = _embed_in(params, cfg, batch)
    for lp, cache, window in zip(params["layers"], caches["layers"],
                                 layer_windows(cfg)):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        h = h + attn.attention_prefill(lp["attn"], x, cfg, cache, index,
                                       lengths, cfg.quant, window)
        h = _ffn(lp, h, cfg)
    return tp.full(_logits(params, cfg, h))


# ---------------------------------------------------------------------------
# Serving: pack every GEMM weight
# ---------------------------------------------------------------------------

def pack_layer_for_serving(layer, fmt: str, group: str = "layers"):
    """One dense block of ``group`` (an attention layer, an mLSTM, sLSTM or
    Mamba2 block, a norm) -> the same block with every GEMM weight packed
    in codec ``fmt``, by the reference's rule: a weight named in
    ``_PACK_KEYS`` is packed if its second-to-last axis is a multiple of
    32; an expert weight (E, K, N) is laid out contraction first, (K, E,
    N), before that test -- for an expert weight the axis is E, so experts
    of a model with E % 32 != 0 stay dense (E, K, N) bf16. The router,
    norms, biases and recurrence parameters stay as they are, and so do
    an mLSTM's per-head ``wq``, ``wk`` and ``wv``."""
    keep = _MLSTM_DENSE if group == "mlstm" else ()

    def convert(name, leaf):
        if isinstance(leaf, dict):
            return {k: convert(k, v) for k, v in leaf.items()}
        if name not in _PACK_KEYS or name in keep or leaf.dim() < 2:
            return leaf
        # experts (E, K, N) -> contraction first (K, E, N), a view
        w = leaf.permute(1, 0, 2) if leaf.dim() == 3 else leaf
        if w.shape[-2] % 32:
            return leaf
        return pack_serving_weight(w.to(torch.float32), fmt)
    return convert("", layer)


def pack_params_for_serving(params: dict, cfg) -> dict:
    """Dense params -> packed streams of ``cfg.quant_format`` for every
    GEMM weight, block by block (``shared_attn`` once); embedding, LM
    head, norms and biases stay as they are."""
    fmt = cfg.quant_format
    out = {}
    for group, node in params.items():
        if isinstance(node, list):
            out[group] = [pack_layer_for_serving(b, fmt, group)
                          for b in node]
        elif isinstance(node, dict):
            out[group] = pack_layer_for_serving(node, fmt, group)
        else:
            out[group] = node
    return out
