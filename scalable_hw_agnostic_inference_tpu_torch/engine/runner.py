"""Engine paths: bucketed prefill, chunked-prefill continuation and one
decode step for the batch.

Port of ``scalable_hw_agnostic_inference_tpu/engine/runner.py``:
``make_prefill`` (``:286``, with its ``prefix_len`` variant),
``make_prefill_cont`` (``:447``,
text-only, both the static-start ladder and ``ragged=True``),
``make_decode`` (``:780``, the ``T = 1`` instantiation of
``_make_token_forward`` at ``:641``, with its ``feedback`` variant),
``make_verify`` (``:889``, speculative decoding's verify step, the
``T = k + 1`` instantiation of the same forward), ``make_fused_step``
(``:995``, the mixed-phase step of ``SHAI_FUSED_STEP``),
``token_logprobs`` (``:129``, the per-token logprob readout) and their
helpers ``_rmsnorm``, ``_scatter_blocks``, ``_pool_scales``,
``_ragged_pool_attention`` and ``_logits``; and ``EngineShardings``
(``:37``), the tensor-parallel plan. The runner reads the weights of
``models.llama.LlamaForCausalLM`` and calls its pieces (the embedding
lookup, each attention's ``qkv`` and ``out``, each MLP's ``swiglu``, the
head's ``logits``), so one set of weights serves the scoring forward and
the engine, and one copy of the tensor-parallel collectives serves both.

Over tensor-parallel ranks (``models.llama``'s ``group``): each rank holds
its ``n_heads / tp`` query and ``n_kv_heads / tp`` kv heads, its pool holds
its kv heads (``[N, bs, Hkv / tp, D]``, an int8 pool's scales ``[N, Hkv /
tp]``), and every function here reads the head counts from the tensors it
is given, never from the config. The kernels take the rank's heads as
they are: no head split around them (the reference's ``_pool_kernel_call``
``shard_map``, ``:386-416``, is that split). The collectives are the
model's: the embedding's feature gather, the all-reduces after ``o`` and
``down``, a tied head's partial logits reduced and an untied head's
gathered, the ones XLA inserts in the reference.

The reference returns jitted executables that donate the KV pool; here the
functions run eagerly and write the pool tensors IN PLACE (the returned
``kv`` is the same list), so a decode step captured as a CUDA graph
(``engine/graphs.py``) keeps the pool's addresses. Attention dispatch follows the tensors' device:
prefill and the static-start continuation go through
``ops.attention.dot_product_attention`` (the B1 flash kernel on CUDA);
bucketed decode through ``ops.cuda.paged_attention.paged_decode_attention``
(B2 on CUDA: the decode CTA of B3's walk on the bucket's truncated tables,
or B3 itself for an int8 pool); ragged decode through
``ops.cuda.ragged_paged_attention`` (B3) and the ragged continuation
through ``ops.attention.ragged_paged_attention`` (B3 on CUDA, the chunk's
rows sharing their sequence's table row through ``rows_per_table``); the
fused step's decode rows and chunk through
``ops.attention.mixed_phase_ragged_attention`` (one B3 launch over row
groups on CUDA). On the CPU
each takes its plain version, as the reference's ``_resolve_paged`` default
and its gather oracle do off the accelerator. The activations are bf16 from
the embedding on (``runner.py:315``), as in the reference, so CPU parity
holds at bf16 tolerances.

mllama (``cross_attention_layers``): ``make_cross_kv`` (``:146``) projects
a request's vision states once, at admission, into each cross layer's
k-normed k/v, and ``make_cross_slot_write`` (``:169``) copies them into the
slot's rows of the engine's per-slot cross buffers, in place. The cross
layers own no KV pool entry (the pool is indexed past them) and run as
``models.llama.LlamaCrossBlock`` (the reference's ``_cross_layer`` at
``:223``, its head norm ``_head_rmsnorm`` included): non-causal
attention over the row's vision
states with ``kv_lengths = cross_len`` through ``dot_product_attention``
(B1 on CUDA) in every path: prefill and the static continuation take the
cross tail ``(cross_kv [K, Lv, Hkv, D] per layer, has_image [K],
cross_len [K])``; decode and verify take the whole buffers, and each batch
row gathers its slot's rows by ``slot_idx`` (``:704-716``). Ragged
continuation and the fused step serve text engines only, as the
reference's assert (``:494``).

``kv_quant`` (``SHAI_KV_QUANT=int8``): the pool holds int8 blocks with
per-(block, kv head) f32 scales ``ks``/``vs``. Whole-block writes quantize
(``_scatter_blocks``), decode writes requantize their block one token at a
time, and reads dequantize (in B3, or after the gather on the plain paths).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    _weight_shapes,
    cache_specs,
    tp_rules,
)
from ..ops.attention import (
    dot_product_attention,
    mixed_phase_ragged_attention,
    ragged_gather_attention,
    ragged_paged_attention,
)
from ..ops.cuda.paged_attention import paged_decode_attention
from ..ops.cuda.ragged_paged_attention import (
    ragged_paged_attention as ragged_kernel,
)
from ..ops.norms import rms_norm
from ..ops.quant import (
    dequantize_kv_blocks,
    quantize_kv_blocks,
    requantize_block_tokens,
)
from ..ops.sampling import (
    masked_scaled_logits,
    sample_excluding,
    sample_logits,
    sampling_probs,
)
from ..parallel.sharding import ShardSpec, shard_shape
from .types import K_LOGPROBS

KVPool = List[Dict[str, torch.Tensor]]


class EngineShardings:
    """The tensor-parallel plan of the engine (the reference's
    ``EngineShardings``, ``runner.py:37``): ``tp``, one rank's head counts
    and widths, the rule table over the weights (``models.llama.
    tp_rules``) and the KV pool's split on its kv-head dim
    (``cache_specs``; an int8 pool's ``[N, Hkv]`` scales split on dim 1).
    The reference turns the plan into ``NamedSharding``s and XLA inserts
    the collectives; here the rank-local modules (``models.llama``, a
    ``group`` of ``tp`` ranks) read the same numbers, and so do the engine
    over ranks (its pool's kv heads) and the per-rank kernel shapes that
    ``chip_smoke.py`` times.
    """

    def __init__(self, cfg: LlamaConfig, tp: int):
        # fail loudly at construction: a GQA config whose head counts don't
        # divide tp would otherwise surface as a shape error deep inside
        # the first call
        if cfg.n_kv_heads % tp or cfg.n_heads % tp:
            raise ValueError(
                f"tensor_parallel_size={tp} must divide both n_heads="
                f"{cfg.n_heads} and n_kv_heads={cfg.n_kv_heads}. For GQA "
                f"models with tp > n_kv_heads (the reference's 70B TP=32 "
                f"tier), widen the kv heads first with "
                f"models.llama.replicate_kv_heads(state, cfg, tp)")
        self.cfg, self.tp = cfg, tp
        self.n_heads = cfg.n_heads // tp
        self.n_kv_heads = cfg.n_kv_heads // tp
        self.head_dim = cfg.head_dim
        self.rules = tp_rules()
        self.kv_layer = cache_specs(cfg, tp)
        self.kv_scale = ShardSpec(1)

    def weight_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """One rank's shape of every weight of the state dict (bf16 names;
        an int8 ``weight_q`` has its weight's shape); a split that ``tp``
        does not divide raises."""
        return {name: shard_shape(name, shape,
                                  self.rules.spec_for(name, len(shape)),
                                  self.tp)
                for name, shape in _weight_shapes(self.cfg).items()}

    def projection_shapes(self) -> Dict[str, Tuple[int, int]]:
        """``{projection: (N, K)}`` of one rank, the ``[out, in]`` of a
        self-attention layer's q, k, v, o, gate, up, down and of the
        ``lm_head`` (a tied head's is the embedding's ``[vocab, dim /
        tp]``, contracted over the rank's features)."""
        shapes = self.weight_shapes()
        i = next(i for i in range(self.cfg.n_layers)
                 if i not in self.cfg.cross_attention_layers)
        out = {p: shapes[f"layers.{i}.attn.{p}.weight"]
               for p in ("q", "k", "v", "o")}
        out.update({p: shapes[f"layers.{i}.mlp.{p}.weight"]
                    for p in ("gate", "up", "down")})
        out["lm_head"] = shapes.get("lm_head.weight",
                                    shapes["embed.weight"])
        return out


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 inside, cast back to ``x``'s dtype."""
    return rms_norm(x, scale, eps).to(x.dtype)


def _scatter_blocks(kv_layer: Dict[str, torch.Tensor], tbl: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, quant: bool) -> None:
    """Write whole fresh KV blocks ``[B, m, Bs, Hkv, Dh]`` into one pool
    layer at block ids ``tbl [B, m]``, in place. Rows and blocks past a
    sequence's allocation carry block id 0 and land in the null block. An
    int8 pool quantizes per block x kv head on the way in and writes the
    scales beside the blocks: every prefill and continuation write goes
    through here."""
    if quant:
        kq, ksc = quantize_kv_blocks(k)
        vq, vsc = quantize_kv_blocks(v)
        kv_layer["k"][tbl] = kq
        kv_layer["v"][tbl] = vq
        kv_layer["ks"][tbl] = ksc
        kv_layer["vs"][tbl] = vsc
        return
    kv_layer["k"][tbl] = k.to(kv_layer["k"].dtype)
    kv_layer["v"][tbl] = v.to(kv_layer["v"].dtype)


def _attn_out_mlp(cfg: LlamaConfig, layer, x: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
    """The rest of a layer after its attention ``o [B, T, H, D]``: the
    output projection and the MLP, each with its residual (under a group,
    each all-reduced across the ranks: the layer's own pieces)."""
    x = x + layer.attn.out(o)
    return x + layer.mlp.swiglu(_rmsnorm(x, layer.mlp_norm.scale,
                                         cfg.rms_eps))


def _chunk_window(block_tables: torch.Tensor, start_arr: torch.Tensor,
                  T: int, block_size: int, c_blocks: int):
    """A ragged continuation chunk's cache positions ``[B, T]`` (from the
    start given as data) and the ``[B, c_blocks]`` block ids its k/v go
    to."""
    dev = block_tables.device
    start_arr = start_arr.to(device=dev, dtype=torch.int64)
    positions = start_arr[:, None] + torch.arange(T, device=dev)[None, :]
    sb = start_arr // block_size
    tbl_chunk = torch.gather(
        block_tables.long(), 1,
        sb[:, None] + torch.arange(c_blocks, device=dev)[None, :])
    return positions, tbl_chunk


def _token_slots(tables: torch.Tensor, pos: torch.Tensor, block_size: int,
                 m_ctx: int):
    """``(blk, widx)`` of new tokens at cache positions ``pos [B, T]``:
    each token's block id (positions past the context window route to the
    null block) and its flat row in the pool."""
    pblk = pos // block_size
    blk = torch.where(
        pblk < m_ctx,
        torch.gather(tables.long(), 1, pblk.clamp(0, m_ctx - 1)),
        torch.zeros_like(pblk))
    return blk, blk * block_size + pos % block_size


def _write_tokens(cfg: LlamaConfig, lay: Dict[str, torch.Tensor],
                  kk: torch.Tensor, vv: torch.Tensor, blk: torch.Tensor,
                  pos: torch.Tensor, widx: torch.Tensor, block_size: int,
                  kv_quant: bool) -> None:
    """Write the k/v of new tokens ``[B, T, Hkv, D]`` into one pool layer
    in place: at ``widx``, or, for an int8 pool, one read-modify-write
    requantize of the target block per new token (a block's scale only
    grows)."""
    if kv_quant:
        for t in range(kk.shape[1]):
            bt = blk[:, t]
            pin = pos[:, t] % block_size
            for name, sname, new in (("k", "ks", kk), ("v", "vs", vv)):
                q8, sc = requantize_block_tokens(
                    lay[name][bt], lay[sname][bt], new[:, t], pin)
                lay[name][bt] = q8
                lay[sname][bt] = sc
    else:
        hkv, hd = lay["k"].shape[2:]   # the rank's kv heads
        lay["k"].view(-1, hkv, hd)[widx] = kk.to(lay["k"].dtype)
        lay["v"].view(-1, hkv, hd)[widx] = vv.to(lay["v"].dtype)


def _pool_scales(kv_layer: Dict[str, torch.Tensor]):
    """``(k_scale, v_scale)`` of an int8 pool layer, ``(None, None)`` for a
    float pool: the read-side twin of :func:`_scatter_blocks`."""
    return kv_layer.get("ks"), kv_layer.get("vs")


def _logits(model: LlamaForCausalLM, x: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    """fp32 logits of the final-normed ``x``; a tied head in fp32 (the
    model's ``logits``, which reduces or gathers them under a group)."""
    return model.logits(_rmsnorm(x, model.final_norm.scale, cfg.rms_eps),
                        tied_fp32=True)


def _embed(model: LlamaForCausalLM, ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> bf16 activations (gathered over a group's ranks)."""
    return model.embed_tokens(ids, torch.bfloat16)


def token_logprobs(logits: torch.Tensor, toks: torch.Tensor):
    """``[B, V]`` raw logits and ``[B]`` sampled ids -> ``(top_ids [B, K]
    i32, top_logprobs [B, K] f32, sampled_logprob [B] f32)`` with ``K =
    K_LOGPROBS``: the raw (pre-temperature) distribution, what the OpenAI
    ``logprobs`` field reports. A log-softmax over the f32 logits, a top-k
    and a gather; plain PyTorch, as the reference leaves them to XLA.
    ``torch.topk`` orders equal values as it likes, where ``jax.lax.top_k``
    puts the lower index first: the values agree, tied ids may not."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    top_lp, top_ids = torch.topk(logp, K_LOGPROBS, dim=-1)
    tok_lp = torch.gather(logp, 1, toks.long()[:, None])[:, 0]
    return top_ids.to(torch.int32), top_lp, tok_lp


CrossKV = List[Dict[str, torch.Tensor]]


def make_cross_kv(cfg: LlamaConfig) -> Callable:
    """``cross_kv(model, states [Lv, dim]) -> [n_cross] x {"k", "v"}``
    ``[Lv, Hkv, Dh]`` bf16: each cross layer's k/v of a request's vision
    states, k normed over the head dim. Run once at admission; prefill,
    the continuation chunks and decode then read the slot's buffers
    (vLLM's encoder cache)."""

    def cross_kv(model: LlamaForCausalLM, states: torch.Tensor) -> CrossKV:
        return [{"k": k[0], "v": v[0]}
                for k, v in model.project_cross(states[None])]

    return cross_kv


def make_cross_slot_write(cfg: LlamaConfig) -> Callable:
    """``write(buffers, per_layer, slot)``: every cross layer's slot rows
    of the engine's buffers ``[max_num_seqs, Lv, Hkv, Dh]`` set from
    ``make_cross_kv``'s output, in place (the buffers are never replaced:
    captured graphs hold their addresses)."""

    def write(buffers: CrossKV, per_layer: CrossKV, slot: int) -> CrossKV:
        for buf, new in zip(buffers, per_layer, strict=True):
            buf["k"][slot].copy_(new["k"])
            buf["v"][slot].copy_(new["v"])
        return buffers

    return write


def make_prefill(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                 bucket: int, n_seqs: int = 1,
                 kv_quant: bool = False, prefix_len: int = 0) -> Callable:
    """``prefill(model, kv, ids [K, bucket - prefix_len], n_text [K],
    block_tables [K, blocks_per_seq][, cross_kv, has_image, cross_len]
    [, prefix=]) -> (kv, logits [K, V])``.

    ``K = n_seqs`` right-padded prompts share one call; rows past the
    admitted group carry a null block table and write harmlessly into
    reserved block 0. k/v for the whole bucket are scattered into the pool;
    pad positions stay masked by the sequence lengths. Returns next-token
    logits from the last valid position of each row. An mllama model takes
    the cross tail: per cross layer ``{"k", "v"}`` ``[K, Lv, Hkv, Dh]``,
    ``has_image [K]`` and ``cross_len [K]``.

    With ``prefix_len`` P > 0 (the soft-prefix VLM, the reference's
    ``:287-383``) ``prefix`` ``[K, P, dim]`` soft embeddings, cast to
    bf16, occupy the first P positions ahead of the text's: the row holds
    ``n = n_text + P`` tokens at positions ``0 ... bucket - 1``, attends
    causally with ``kv_lengths = n`` (B1 on CUDA), and its logits are
    read at ``n - 1``. An mllama model takes no prefix.
    """
    if bucket % block_size:
        raise ValueError(f"bucket {bucket} not a multiple of block_size "
                         f"{block_size}")
    if not 0 <= prefix_len < bucket:
        raise ValueError(f"prefix_len {prefix_len} outside [0, {bucket})")
    m_used = bucket // block_size
    cross_set = set(cfg.cross_attention_layers)
    if prefix_len and cross_set:
        raise ValueError("mllama prefill takes cross states, not a soft "
                         "prefix")

    def prefill(model: LlamaForCausalLM, kv: KVPool, ids: torch.Tensor,
                n_text: torch.Tensor, block_tables: torch.Tensor,
                cross_kv: Optional[CrossKV] = None,
                has_image: Optional[torch.Tensor] = None,
                cross_len: Optional[torch.Tensor] = None,
                prefix: Optional[torch.Tensor] = None
                ) -> Tuple[KVPool, torch.Tensor]:
        x = _embed(model, ids)
        n = n_text
        if prefix_len:
            if prefix is None or tuple(prefix.shape[1:]) != (prefix_len,
                                                              cfg.dim):
                raise ValueError(f"prefill of prefix_len {prefix_len} takes "
                                 f"prefix [K, {prefix_len}, {cfg.dim}]")
            x = torch.cat([prefix.to(x.device, torch.bfloat16), x], dim=1)
            n = n_text + prefix_len
        B, T = x.shape[:2]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=ids.device).expand(B, T)
        tbl = block_tables[:, :m_used].long()
        ci = pi = 0   # cross layers own no pool entry
        for li, layer in enumerate(model.layers):
            if li in cross_set:
                x = layer(x, cross_kv[ci]["k"], cross_kv[ci]["v"],
                          has_image, cross_len)
                ci += 1
                continue
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, k, v = layer.attn.qkv(h, positions)
            # causal within the prompt; pad keys masked by the true length
            # (kv_lengths, not a mask, keeps the flash kernel eligible)
            o = dot_product_attention(q, k, v, kv_lengths=n, causal=True)
            x = _attn_out_mlp(cfg, layer, x, o)
            _scatter_blocks(
                kv[pi], tbl,
                k.reshape(B, m_used, block_size, *k.shape[2:]),
                v.reshape(B, m_used, block_size, *v.shape[2:]), kv_quant)
            pi += 1
        last = x[torch.arange(B, device=x.device), n.long() - 1]
        return kv, _logits(model, last[:, None], cfg)[:, 0]

    return prefill


def _ragged_pool_attention(q: torch.Tensor, kv_layer: Dict[str, torch.Tensor],
                           tables: torch.Tensor, positions: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """Ragged attention of ``[B, T, H, D]`` queries over the paged pool,
    query ``(b, t)`` seeing positions ``<= positions[b, t]``: on CUDA the
    ``T`` queries flatten into rows of B3, one length each, the ``T`` rows
    of a sequence sharing its table row (``rows_per_table=T``); on the CPU
    the gather path takes the ``[B, T]`` layout as it is. An int8 pool's
    scales ride along either way."""
    B, T, H, D = q.shape
    ks, vs = _pool_scales(kv_layer)
    kpool, vpool = kv_layer["k"], kv_layer["v"]
    if q.device.type == "cpu":
        return ragged_gather_attention(q, kpool, vpool, tables, positions,
                                       ks, vs)
    L = tables.shape[1] * block_size
    lf = (positions + 1).clamp(1, L).reshape(B * T)
    o = ragged_paged_attention(
        q.reshape(B * T, H, D).contiguous(), kpool, vpool,
        tables.to(torch.int32).contiguous(), lf.to(torch.int32).contiguous(),
        ks, vs, rows_per_table=T)
    return o.reshape(B, T, H, D)


def make_prefill_cont(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                      bucket: int, start_blocks: int = 0,
                      kv_quant: bool = False,
                      ragged: bool = False) -> Callable:
    """A continuation chunk of a prompt longer than the largest prefill
    bucket: ``cont(model, kv, ids [1, bucket], n_text [1], block_tables
    [1, blocks_per_seq][, start [1]]) -> (kv, next_logits [1, V])``.

    Static start (the default): the chunk's first token sits at position
    ``start = start_blocks * block_size``, fixed per function (one per
    start, the reference's ladder). The ``start`` tokens already in the
    pool are gathered densely through the table (dequantized for an int8
    pool), concatenated with the chunk's own k/v, and the chunk attends
    ``[prior, chunk]`` causally through ``dot_product_attention`` with
    ``kv_lengths = start + n_text`` (B1 on CUDA); the chunk's blocks are
    written after the attention.

    ``ragged`` (``SHAI_RAGGED_ATTENTION``): the start is data, one function
    per chunk bucket. The chunk's blocks are written FIRST, then its
    queries attend through the pool with lengths ``start + t + 1``
    (B3 on CUDA). With an int8 pool the two orders give different numbers
    (the ragged chunk reads its own keys back quantized), and each variant
    keeps the reference's.

    An mllama model chunks on the static ladder only, its calls taking
    prefill's cross tail (one row: the slot's buffers); ragged serves text
    engines (the reference's assert).
    """
    cross_set = set(cfg.cross_attention_layers)
    if ragged and cross_set:
        raise ValueError("the ragged continuation serves text engines: an "
                         "mllama engine runs the static ladder")
    if bucket % block_size:
        raise ValueError(f"bucket {bucket} not a multiple of block_size "
                         f"{block_size}")
    start = start_blocks * block_size
    c_blocks = bucket // block_size
    if not ragged and not (1 <= start_blocks
                           and start_blocks + c_blocks <= blocks_per_seq):
        raise ValueError(f"static continuation start {start_blocks} blocks "
                         f"+ {c_blocks} chunk blocks outside [1, "
                         f"{blocks_per_seq}]")

    def _blocks(t, B):
        return t.reshape(B, c_blocks, block_size, *t.shape[2:])

    def cont_ragged(model: LlamaForCausalLM, kv: KVPool, ids: torch.Tensor,
                    n_text: torch.Tensor, block_tables: torch.Tensor,
                    start_arr: torch.Tensor) -> Tuple[KVPool, torch.Tensor]:
        B, T = ids.shape
        dev = ids.device
        x = _embed(model, ids)
        positions, tbl_chunk = _chunk_window(block_tables, start_arr, T,
                                             block_size, c_blocks)
        tables = block_tables[:, :blocks_per_seq]
        for li, layer in enumerate(model.layers):
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, k, v = layer.attn.qkv(h, positions)
            # the chunk goes in first: its queries then read their own keys
            # through the pool, in the pool's table order
            _scatter_blocks(kv[li], tbl_chunk, _blocks(k, B), _blocks(v, B),
                            kv_quant)
            o = _ragged_pool_attention(q, kv[li], tables, positions,
                                       block_size)
            x = _attn_out_mlp(cfg, layer, x, o)
        last = x[torch.arange(B, device=dev), n_text.long() - 1]
        return kv, _logits(model, last[:, None], cfg)[:, 0]

    def cont_static(model: LlamaForCausalLM, kv: KVPool, ids: torch.Tensor,
                    n_text: torch.Tensor, block_tables: torch.Tensor,
                    cross_kv: Optional[CrossKV] = None,
                    has_image: Optional[torch.Tensor] = None,
                    cross_len: Optional[torch.Tensor] = None
                    ) -> Tuple[KVPool, torch.Tensor]:
        B, T = ids.shape
        dev = ids.device
        x = _embed(model, ids)
        n = n_text + start          # valid tokens after this chunk
        positions = (start + torch.arange(T, dtype=torch.int32, device=dev)
                     ).expand(B, T)
        tbl_prior = block_tables[:, :start_blocks].long()
        goff = (tbl_prior[:, :, None] * block_size
                + torch.arange(block_size, device=dev)[None, None, :]
                ).reshape(B, start)
        tbl_chunk = block_tables[:, start_blocks:start_blocks + c_blocks
                                 ].long()
        ci = pi = 0   # cross layers own no pool entry
        for li, layer in enumerate(model.layers):
            if li in cross_set:
                x = layer(x, cross_kv[ci]["k"], cross_kv[ci]["v"],
                          has_image, cross_len)
                ci += 1
                continue
            lay = kv[pi]
            pi += 1
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, k, v = layer.attn.qkv(h, positions)
            hkv, hd = k.shape[2:]   # the rank's kv heads
            if kv_quant:
                kprior = dequantize_kv_blocks(
                    lay["k"][tbl_prior], lay["ks"][tbl_prior],
                    q.dtype).reshape(B, start, hkv, hd)
                vprior = dequantize_kv_blocks(
                    lay["v"][tbl_prior], lay["vs"][tbl_prior],
                    q.dtype).reshape(B, start, hkv, hd)
            else:
                kprior = lay["k"].view(-1, hkv, hd)[goff].to(q.dtype)
                vprior = lay["v"].view(-1, hkv, hd)[goff].to(q.dtype)
            o = dot_product_attention(
                q, torch.cat([kprior, k], dim=1),
                torch.cat([vprior, v], dim=1), kv_lengths=n, causal=True)
            x = _attn_out_mlp(cfg, layer, x, o)
            _scatter_blocks(lay, tbl_chunk, _blocks(k, B), _blocks(v, B),
                            kv_quant)
        last = x[torch.arange(B, device=dev), n_text.long() - 1]
        return kv, _logits(model, last[:, None], cfg)[:, 0]

    return cont_ragged if ragged else cont_static


def _make_token_forward(cfg: LlamaConfig, block_size: int, m_ctx: int,
                        max_num_seqs: int, T: int, ragged: bool = False,
                        kv_quant: bool = False) -> Callable:
    """The paged-engine forward for ``T`` new tokens per sequence (decode
    is ``T = 1``): ``fwd(model, kv, tokens [B, T], positions [B, T],
    tables [B, >= m_ctx][, cross]) -> (kv, logits [B, T, V])``; an mllama
    model's ``cross`` is ``(buffers, has_image [B], slot_idx [B],
    cross_len [B])``: the engine's whole per-slot buffers, each batch row
    gathering its slot's rows by ``slot_idx`` (a copy ``[B, Lv, Hkv, Dh]``
    per cross layer).

    Writes the ``T`` tokens' kv into the pool in place (positions past the
    context window route to the null block; an int8 pool requantizes the
    target block once per token), then every query attends its own causal
    window, the ``T`` queries flattened into the row axis with per-row
    lengths: through B3 with ``ragged`` (the full window), else through
    ``paged_decode_attention`` over the ``m_ctx``-block context bucket
    (B2, which runs on B3's decode CTA and hands an int8 pool to B3).
    """
    L = block_size * m_ctx
    cross_set = set(cfg.cross_attention_layers)

    def fwd(model: LlamaForCausalLM, kv: KVPool, tokens: torch.Tensor,
            positions: torch.Tensor, tables: torch.Tensor,
            cross: Optional[Tuple] = None) -> Tuple[KVPool, torch.Tensor]:
        B = max_num_seqs
        tables = tables[:, :m_ctx].to(torch.int32).contiguous()
        x = _embed(model, tokens)  # [B, T, d]
        pos = positions.long()
        blk, widx = _token_slots(tables, pos, block_size, m_ctx)   # [B, T]
        tables_f = tables.repeat_interleave(T, dim=0) if T > 1 else tables
        lengths_f = (pos + 1).clamp(1, L).reshape(B * T).to(torch.int32)
        attend = ragged_kernel if ragged else paged_decode_attention
        ci = pi = 0   # cross layers own no pool entry
        for li, layer in enumerate(model.layers):
            if li in cross_set:
                bufs, has_image, slot_idx, cross_len = cross
                sl = slot_idx.long()
                x = layer(x, bufs[ci]["k"].index_select(0, sl),
                          bufs[ci]["v"].index_select(0, sl), has_image,
                          cross_len)
                ci += 1
                continue
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, kk, vv = layer.attn.qkv(h, positions)
            lay = kv[pi]
            pi += 1
            _write_tokens(cfg, lay, kk, vv, blk, pos, widx, block_size,
                          kv_quant)
            ksc, vsc = _pool_scales(lay)
            H, hd = q.shape[2:]     # the rank's heads
            o = attend(q.reshape(B * T, H, hd).contiguous(),
                       lay["k"], lay["v"], tables_f, lengths_f, ksc,
                       vsc).reshape(B, T, H, hd)
            x = _attn_out_mlp(cfg, layer, x, o)
        return kv, _logits(model, x, cfg)

    return fwd


def make_decode(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                max_num_seqs: int, ctx_blocks: Optional[int] = None,
                ragged: bool = False, kv_quant: bool = False,
                feedback: bool = False) -> Callable:
    """One decode step for the whole (compacted) slot batch:
    ``decode(model, kv, tokens [B], pos [B], tables [B, M], rng,
    temperature [B], top_k [B], top_p [B]) -> (kv, next_tokens [B])``.

    ``rng`` is the step's randomness: a ``torch.Generator`` on the
    device, or the uniforms ``[B, V]`` already drawn from one (what a
    captured graph reads, ``engine/graphs.py``; the same draws give the
    same tokens).

    ``feedback``: the async pipeline's variant (``SHAI_ASYNC_DECODE``,
    reference ``runner.py:780-800,850-860``), which the engine runs under
    both disciplines: ``(kv, next_tokens, pos + 1, top_ids [B, K],
    top_lp [B, K], tok_lp [B])``. Step N's sampled tokens and positions
    feed step N+1 on the device without the host, and the logprob readout
    (:func:`token_logprobs`) rides along on every step; the engine copies
    it to the host only when a running request asked for logprobs.

    ``pos[b]`` is where the new token is written (== tokens so far);
    padding rows carry zero tables and write into the null block.
    ``ctx_blocks`` bounds the attention window to the first ``ctx_blocks``
    table entries — the engine's context bucket, so decode cost follows
    the context in use. ``max_num_seqs`` is this call's batch bucket.
    ``ragged`` (``SHAI_RAGGED_ATTENTION``): the window is the full table
    and B3 follows each row's own length, so there is no context bucket.
    ``kv_quant``: the pool is int8 (``SHAI_KV_QUANT=int8``). The pool is
    written in place, so a captured graph keeps its addresses. An mllama
    model's step takes ``cross=(buffers, has_image, slot_idx, cross_len)``
    (see :func:`_make_token_forward`).
    """
    m_ctx = blocks_per_seq if ctx_blocks is None else ctx_blocks
    if not 1 <= m_ctx <= blocks_per_seq:
        raise ValueError(f"ctx_blocks {m_ctx} outside [1, {blocks_per_seq}]")
    if ragged and m_ctx != blocks_per_seq:
        raise ValueError("ragged decode owns the full window; it takes no "
                         "context bucket")
    fwd = _make_token_forward(cfg, block_size, m_ctx, max_num_seqs, 1,
                              ragged=ragged, kv_quant=kv_quant)

    def decode(model: LlamaForCausalLM, kv: KVPool, tokens: torch.Tensor,
               pos: torch.Tensor, tables: torch.Tensor,
               rng: Union[torch.Generator, torch.Tensor],
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor, cross: Optional[Tuple] = None):
        kv, logits = fwd(model, kv, tokens[:, None], pos[:, None], tables,
                         cross)
        logits = logits[:, 0]
        nxt = sample_logits(logits, rng, temperature, top_k, top_p)
        if feedback:
            return (kv, nxt, pos + 1) + token_logprobs(logits, nxt)
        return kv, nxt

    return decode


def make_verify(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                max_num_seqs: int, k: int, ctx_blocks: Optional[int] = None,
                ragged: bool = False, kv_quant: bool = False) -> Callable:
    """One speculative VERIFY step: ``k + 1`` positions per sequence scored
    in one walk of the pool (the reference's ``runner.py:889``).

    ``verify(model, kv, tokens [B, k+1], pos0 [B], tables [B, M], rng,
    temperature [B], top_k [B], top_p [B]) -> (kv, o [B, k+1], oex [B, k],
    accept_p [B, k], o_lp [B, k+1], d_lp [B, k], oex_lp [B, k], top_ids
    [B, k+1, K], top_lp [B, k+1, K])``.

    ``tokens[:, 0]`` is each slot's pending token, ``tokens[:, 1:]`` its
    draft, zero-padded past the slot's draft length (padded positions write
    into the null block or the reserved tail of a real block, as the
    reference's do, and their outputs are never committed). ``pos0[b]`` is
    the cache index the pending token is written at; position ``i`` lands
    at ``pos0 + i``. The layer stack is :func:`_make_token_forward` at
    ``T = k + 1``, decode's own: the ``T`` queries flatten into ``B * T``
    rows over the tables repeated ``T`` times, with lengths ``pos0 + 1 ...
    pos0 + T`` (B2 over the context bucket, or B3 with ``ragged``, on
    CUDA); an int8 pool requantizes its target block once per token,
    unrolled ``T`` times.

    ``rng``: the step's two sets of draws, uniforms ``(u_o [B, k+1, V],
    u_ex [B, k, V])`` (the reference's ``fold_in(rng, 1)`` and
    ``fold_in(rng, 2)``; what a captured graph reads), or a generator that
    draws them in that order.

    Per position ``i`` (predicting the token at ``pos0 + i + 1``): ``o`` a
    sample of the full target distribution (the argmax at temperature 0),
    ``oex`` a sample with the draft token removed AFTER the top-k and top-p
    masks (``ops.sampling.sample_excluding``), ``accept_p`` the draft
    token's probability under the sampling distribution
    (``ops.sampling.sampling_probs``), and the raw logprob readout of every
    token the engine may commit: ``o_lp``, ``d_lp``, ``oex_lp`` and the
    top-K alternatives. :func:`~..ops.sampling.masked_scaled_logits` is
    computed once and shared by the three draws (its sorts over ``[B, k+1,
    V]`` are not cheap; the results are the same). The acceptance walk is
    the host's (``speculative.accept_drafts``). An mllama model takes
    decode's ``cross`` (the reference's verify cross tail).
    """
    if k < 1:
        raise ValueError(f"num_speculative_tokens {k} < 1")
    m_ctx = blocks_per_seq if ctx_blocks is None else ctx_blocks
    if not 1 <= m_ctx <= blocks_per_seq:
        raise ValueError(f"ctx_blocks {m_ctx} outside [1, {blocks_per_seq}]")
    if ragged and m_ctx != blocks_per_seq:
        raise ValueError("ragged verify owns the full window; it takes no "
                         "context bucket")
    T = k + 1
    fwd = _make_token_forward(cfg, block_size, m_ctx, max_num_seqs, T,
                              ragged=ragged, kv_quant=kv_quant)

    def verify(model: LlamaForCausalLM, kv: KVPool, tokens: torch.Tensor,
               pos0: torch.Tensor, tables: torch.Tensor, rng,
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor, cross: Optional[Tuple] = None):
        B = max_num_seqs
        dev = tokens.device
        positions = pos0[:, None] + torch.arange(T, dtype=pos0.dtype,
                                                 device=dev)[None, :]
        kv, logits = fwd(model, kv, tokens, positions, tables,
                         cross)  # [B, T, V]
        draft = tokens[:, 1:].long()
        bt = temperature[:, None].expand(B, T)
        bk = top_k[:, None].expand(B, T)
        bp = top_p[:, None].expand(B, T)
        if isinstance(rng, torch.Generator):
            V = logits.shape[-1]
            u_o = torch.rand((B, T, V), generator=rng, device=dev)
            u_ex = torch.rand((B, k, V), generator=rng, device=dev)
        else:
            u_o, u_ex = rng
        masked = masked_scaled_logits(logits, bt, bk, bp)
        o_tok = sample_logits(logits, u_o, bt, bk, bp, masked=masked)
        lk, bt, bk, bp, mk = (logits[:, :k], bt[:, :k], bk[:, :k],
                              bp[:, :k], masked[:, :k])
        oex = sample_excluding(lk, u_ex, draft, bt, bk, bp, masked=mk)
        accept_p = torch.gather(
            sampling_probs(lk, bt, bk, bp, masked=mk), -1,
            draft[..., None])[..., 0]
        # the raw (pre-temperature) logprob readout of every committable
        # token
        logp = torch.log_softmax(logits.float(), dim=-1)
        top_lp, top_ids = torch.topk(logp, K_LOGPROBS, dim=-1)
        o_lp = torch.gather(logp, -1, o_tok.long()[..., None])[..., 0]
        d_lp = torch.gather(logp[:, :k], -1, draft[..., None])[..., 0]
        oex_lp = torch.gather(logp[:, :k], -1, oex.long()[..., None])[..., 0]
        return (kv, o_tok, oex, accept_p, o_lp, d_lp, oex_lp,
                top_ids.to(torch.int32), top_lp)

    return verify


def make_fused_step(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                    max_num_seqs: int, bucket: int,
                    kv_quant: bool = False) -> Callable:
    """ONE mixed-phase engine step (``SHAI_FUSED_STEP``): the whole decode
    batch plus one chunked-prefill continuation window.

    ``fused(model, kv, tokens [B], pos [B], tables [B, M], rng,
    temperature [B], top_k [B], top_p [B], c_ids [1, C], c_ntext [1],
    c_table [1, M], c_start [1]) -> (kv, next [B], pos + 1, top_ids,
    top_lp, tok_lp, c_logits [1, V])``, with ``rng`` as in
    :func:`make_decode` (the reference's unused ``active`` rows are left
    out, as ``make_decode`` leaves them out).

    Two sections share one layer walk over the pool, written in place:

    - the decode section is ``make_decode``'s math (the ragged ``T = 1``
      forward: the same writes, the same int8 read-modify-write
      requantize), with sampling and the logprob readout;
    - the chunk section is the ragged continuation's
      (``make_prefill_cont(ragged=True)``): ``c_start`` as data, the chunk
      scattered first, its queries attending through the pool. Its
      ``c_logits`` come back raw: the engine samples a final chunk on the
      host as the laddered path does. A step with no chunk passes the null
      window (zero ids and table, ``c_ntext`` 1, ``c_start`` 0): it writes
      into the reserved null block 0 and its logits are dropped.

    In every layer the chunk scatters BEFORE the decode rows write, the
    laddered engine's device order (its continuation finishes before the
    decode step that follows it), so a write through a stale table lands
    alike and fused-on equals fused-off. On CUDA both sections' queries go
    through ONE B3 launch (``mixed_phase_ragged_attention``, row groups);
    on the CPU each section keeps its laddered function's plain attention
    (B3's plain version for decode, the gather path for the chunk), so the
    two engines agree bit for bit there.

    One function per batch bucket ``B`` replaces the decode ladder and the
    ragged continuation: the window ``C = bucket`` is the largest prefill
    bucket, and ragged owns the full ``blocks_per_seq`` window.
    """
    if bucket % block_size:
        raise ValueError(f"bucket {bucket} not a multiple of block_size "
                         f"{block_size}")
    if cfg.cross_attention_layers:
        raise ValueError("the fused step serves text engines (the ragged "
                         "gate): an mllama engine runs the ladder")
    m_ctx = blocks_per_seq
    c_blocks = bucket // block_size
    L = block_size * m_ctx

    def fused(model: LlamaForCausalLM, kv: KVPool, tokens: torch.Tensor,
              pos: torch.Tensor, tables: torch.Tensor,
              rng: Union[torch.Generator, torch.Tensor],
              temperature: torch.Tensor, top_k: torch.Tensor,
              top_p: torch.Tensor, c_ids: torch.Tensor,
              c_ntext: torch.Tensor, c_table: torch.Tensor,
              c_start: torch.Tensor):
        B, C = max_num_seqs, bucket
        dev = tokens.device
        # the decode section's inputs: make_decode's (T = 1)
        tables = tables[:, :m_ctx].to(torch.int32).contiguous()
        x = _embed(model, tokens[:, None])
        positions = pos[:, None]
        p64 = positions.long()
        blk, widx = _token_slots(tables, p64, block_size, m_ctx)
        lengths = (p64 + 1).clamp(1, L).reshape(B).to(torch.int32)
        # the chunk section's inputs: the ragged continuation's
        xc = _embed(model, c_ids)
        c_positions, tbl_chunk = _chunk_window(c_table, c_start, C,
                                               block_size, c_blocks)
        c_tables = c_table[:, :m_ctx]
        for li, layer in enumerate(model.layers):
            lay = kv[li]
            hc = _rmsnorm(xc, layer.attn_norm.scale, cfg.rms_eps)
            qc, kc, vc = layer.attn.qkv(hc, c_positions)
            H, hd = qc.shape[2:]    # the rank's heads
            # the chunk goes in FIRST (the laddered device order)
            _scatter_blocks(
                lay, tbl_chunk,
                kc.reshape(1, c_blocks, block_size, *kc.shape[2:]),
                vc.reshape(1, c_blocks, block_size, *vc.shape[2:]), kv_quant)
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, kk, vv = layer.attn.qkv(h, positions)
            _write_tokens(cfg, lay, kk, vv, blk, p64, widx, block_size,
                          kv_quant)
            ksc, vsc = _pool_scales(lay)
            if dev.type == "cuda":
                o, oc = mixed_phase_ragged_attention(
                    q.reshape(B, H, hd), qc.reshape(C, H, hd), lay["k"],
                    lay["v"], tables, c_tables, pos,
                    c_positions.reshape(C), ksc, vsc)
                o = o.reshape(B, 1, H, hd)
                oc = oc.reshape(1, C, H, hd)
            else:
                o = ragged_kernel(q.reshape(B, H, hd).contiguous(), lay["k"],
                                  lay["v"], tables, lengths, ksc,
                                  vsc).reshape(B, 1, H, hd)
                oc = _ragged_pool_attention(qc, lay, c_tables, c_positions,
                                            block_size)
            x = _attn_out_mlp(cfg, layer, x, o)
            xc = _attn_out_mlp(cfg, layer, xc, oc)
        logits = _logits(model, x, cfg)[:, 0]
        nxt = sample_logits(logits, rng, temperature, top_k, top_p)
        last = xc[torch.arange(1, device=dev), c_ntext.long() - 1]
        c_logits = _logits(model, last[:, None], cfg)[:, 0]
        return (kv, nxt, pos + 1) + token_logprobs(logits, nxt) + (c_logits,)

    return fused
