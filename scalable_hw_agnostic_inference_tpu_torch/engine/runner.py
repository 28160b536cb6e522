"""Engine paths: bucketed prefill + one decode step for the batch.

Port of ``scalable_hw_agnostic_inference_tpu/engine/runner.py``:
``make_prefill`` (``:286``, text-only), ``make_decode`` (``:780``, the
``T = 1`` instantiation of ``_make_token_forward`` at ``:641``) and their
helpers ``_rmsnorm``, ``_qkv``, ``_mlp``, ``_scatter_blocks`` (bf16 branch)
and ``_logits``. The runner reads the weights of
``models.llama.LlamaForCausalLM``, so one set of weights serves the scoring
forward and the engine.

The reference returns jitted executables that donate the KV pool; here the
functions run eagerly and write the pool tensors IN PLACE (the returned
``kv`` is the same list). Attention dispatch follows the tensors' device:
prefill goes through ``ops.attention.dot_product_attention`` (the B1 flash
kernel on CUDA for eligible shapes), decode through
``ops.cuda.paged_attention.paged_decode_attention`` — the B2 kernel on
CUDA, its plain dense-gather version on the CPU. That is the reference's
``_resolve_paged`` default (kernel on the accelerator, dense gather off it)
with the choice made by the wrapper. The activations are bf16 from the
embedding on (``runner.py:315``), as in the reference, so CPU parity holds
at bf16 tolerances.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..ops.attention import dot_product_attention
from ..ops.cuda.paged_attention import paged_decode_attention
from ..ops.norms import rms_norm
from ..ops.quant import quant_matmul
from ..ops.rope import apply_rope
from ..ops.sampling import sample_logits

KVPool = List[Dict[str, torch.Tensor]]


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 inside, cast back to ``x``'s dtype."""
    return rms_norm(x, scale, eps).to(x.dtype)


def _qkv(layer, x: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig):
    B, T, _ = x.shape
    hd = cfg.head_dim
    q = quant_matmul(x, layer.attn.q.weight).reshape(B, T, cfg.n_heads, hd)
    k = quant_matmul(x, layer.attn.k.weight).reshape(B, T, cfg.n_kv_heads, hd)
    v = quant_matmul(x, layer.attn.v.weight).reshape(B, T, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    return q, k, v


def _mlp(layer, x: torch.Tensor) -> torch.Tensor:
    gate = quant_matmul(x, layer.mlp.gate.weight)
    up = quant_matmul(x, layer.mlp.up.weight)
    return quant_matmul(torch.nn.functional.silu(gate) * up,
                        layer.mlp.down.weight)


def _scatter_blocks(kv_layer: Dict[str, torch.Tensor], tbl: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> None:
    """Write whole fresh KV blocks ``[B, m, Bs, Hkv, Dh]`` into one pool
    layer at block ids ``tbl [B, m]``, in place. Rows and blocks past a
    sequence's allocation carry block id 0 and land in the null block."""
    kv_layer["k"][tbl] = k.to(kv_layer["k"].dtype)
    kv_layer["v"][tbl] = v.to(kv_layer["v"].dtype)


def _logits(model: LlamaForCausalLM, x: torch.Tensor,
            cfg: LlamaConfig) -> torch.Tensor:
    x = _rmsnorm(x, model.final_norm.scale, cfg.rms_eps)
    if cfg.tie_embeddings:
        return x.float() @ model.embed.weight.float().T
    return quant_matmul(x, model.lm_head.weight).float()


def make_prefill(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                 bucket: int, n_seqs: int = 1) -> Callable:
    """``prefill(model, kv, ids [K, bucket], n_text [K], block_tables
    [K, blocks_per_seq]) -> (kv, logits [K, V])``.

    ``K = n_seqs`` right-padded prompts share one call; rows past the
    admitted group carry a null block table and write harmlessly into
    reserved block 0. k/v for the whole bucket are scattered into the pool;
    pad positions stay masked by the sequence lengths. Returns next-token
    logits from the last valid position of each row.
    """
    if bucket % block_size:
        raise ValueError(f"bucket {bucket} not a multiple of block_size "
                         f"{block_size}")
    m_used = bucket // block_size

    def prefill(model: LlamaForCausalLM, kv: KVPool, ids: torch.Tensor,
                n_text: torch.Tensor, block_tables: torch.Tensor
                ) -> Tuple[KVPool, torch.Tensor]:
        B, T = ids.shape
        x = model.embed.weight[ids.long()].to(torch.bfloat16)
        positions = torch.arange(T, dtype=torch.int32,
                                 device=ids.device).expand(B, T)
        tbl = block_tables[:, :m_used].long()
        for li, layer in enumerate(model.layers):
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, k, v = _qkv(layer, h, positions, cfg)
            # causal within the prompt; pad keys masked by the true length
            # (kv_lengths, not a mask, keeps the flash kernel eligible)
            o = dot_product_attention(q, k, v, kv_lengths=n_text, causal=True)
            x = x + quant_matmul(o.reshape(B, T, -1), layer.attn.o.weight)
            x = x + _mlp(layer, _rmsnorm(x, layer.mlp_norm.scale,
                                         cfg.rms_eps))
            _scatter_blocks(
                kv[li], tbl,
                k.reshape(B, m_used, block_size, cfg.n_kv_heads,
                          cfg.head_dim),
                v.reshape(B, m_used, block_size, cfg.n_kv_heads,
                          cfg.head_dim))
        last = x[torch.arange(B, device=x.device), n_text.long() - 1]
        return kv, _logits(model, last[:, None], cfg)[:, 0]

    return prefill


def _make_token_forward(cfg: LlamaConfig, block_size: int, m_ctx: int,
                        max_num_seqs: int, T: int) -> Callable:
    """The paged-engine forward for ``T`` new tokens per sequence (decode
    is ``T = 1``): ``fwd(model, kv, tokens [B, T], positions [B, T],
    tables [B, >= m_ctx]) -> (kv, logits [B, T, V])``.

    Scatters the ``T`` tokens' kv into the pool in place — positions past
    the context window route to the null block — then every query attends
    its own causal window through ``paged_decode_attention``, the ``T``
    queries flattened into the row axis with per-row lengths.
    """
    L = block_size * m_ctx

    def fwd(model: LlamaForCausalLM, kv: KVPool, tokens: torch.Tensor,
            positions: torch.Tensor, tables: torch.Tensor
            ) -> Tuple[KVPool, torch.Tensor]:
        B = max_num_seqs
        hd = cfg.head_dim
        tables = tables[:, :m_ctx].to(torch.int32).contiguous()
        x = model.embed.weight[tokens.long()].to(torch.bfloat16)  # [B,T,d]
        pos = positions.long()
        pblk = pos // block_size
        blk = torch.where(
            pblk < m_ctx,
            torch.gather(tables.long(), 1, pblk.clamp(0, m_ctx - 1)),
            torch.zeros_like(pblk))
        widx = blk * block_size + pos % block_size           # [B, T]
        tables_f = tables.repeat_interleave(T, dim=0) if T > 1 else tables
        lengths_f = (pos + 1).clamp(1, L).reshape(B * T).to(torch.int32)
        for li, layer in enumerate(model.layers):
            h = _rmsnorm(x, layer.attn_norm.scale, cfg.rms_eps)
            q, kk, vv = _qkv(layer, h, positions, cfg)
            kpool, vpool = kv[li]["k"], kv[li]["v"]
            kpool.view(-1, cfg.n_kv_heads, hd)[widx] = kk.to(kpool.dtype)
            vpool.view(-1, cfg.n_kv_heads, hd)[widx] = vv.to(vpool.dtype)
            o = paged_decode_attention(
                q.reshape(B * T, cfg.n_heads, hd).contiguous(), kpool, vpool,
                tables_f, lengths_f).reshape(B, T, cfg.n_heads, hd)
            x = x + quant_matmul(o.reshape(B, T, -1), layer.attn.o.weight)
            x = x + _mlp(layer, _rmsnorm(x, layer.mlp_norm.scale,
                                         cfg.rms_eps))
        return kv, _logits(model, x, cfg)

    return fwd


def make_decode(cfg: LlamaConfig, block_size: int, blocks_per_seq: int,
                max_num_seqs: int, ctx_blocks: int = None) -> Callable:
    """One decode step for the whole (compacted) slot batch:
    ``decode(model, kv, tokens [B], pos [B], tables [B, M], generator,
    temperature [B], top_k [B], top_p [B]) -> (kv, next_tokens [B])``.

    ``pos[b]`` is where the new token is written (== tokens so far);
    padding rows carry zero tables and write into the null block.
    ``ctx_blocks`` bounds the attention window to the first ``ctx_blocks``
    table entries — the engine's context bucket, so decode cost follows
    the context in use. ``max_num_seqs`` is this call's batch bucket.
    """
    m_ctx = blocks_per_seq if ctx_blocks is None else ctx_blocks
    if not 1 <= m_ctx <= blocks_per_seq:
        raise ValueError(f"ctx_blocks {m_ctx} outside [1, {blocks_per_seq}]")
    fwd = _make_token_forward(cfg, block_size, m_ctx, max_num_seqs, 1)

    def decode(model: LlamaForCausalLM, kv: KVPool, tokens: torch.Tensor,
               pos: torch.Tensor, tables: torch.Tensor,
               generator: torch.Generator, temperature: torch.Tensor,
               top_k: torch.Tensor, top_p: torch.Tensor
               ) -> Tuple[KVPool, torch.Tensor]:
        kv, logits = fwd(model, kv, tokens[:, None], pos[:, None], tables)
        nxt = sample_logits(logits[:, 0], generator, temperature, top_k,
                            top_p)
        return kv, nxt

    return decode
