"""Sequence (context) parallelism (port of ``avatar_tpu/parallel/sequence.py``).

The token axis of the denoiser shards over a mesh axis ('sp'), one
process per shard:

- :func:`ulysses_attention`: an all-to-all re-shards heads <-> tokens so
  every rank holds all tokens for H/s heads, runs the local attention
  (kernels C, D or E on the card) and an inverse all-to-all restores the
  token sharding. The chunk order is that of JAX's tiled ``all_to_all``.
- :func:`ring_attention`: queries stay, the k/v (and kv-mask) shards
  rotate around the ring; no ``heads % s`` constraint. The dense chunk
  path (bounded or online softmax) degrades a fully-masked row to uniform
  attention; :func:`ring_flash_attention` runs the flash forward (C, D or
  E) on each chunk and merges by log-sum-exp, and its backward runs the
  flash backward (F) per chunk, a fully-masked row giving 0.
- :func:`dit_apply_sp`: the whole DiT with token-sharded activations,
  optionally with the batch over a data axis too.

Each function takes this rank's group along the axis
(:meth:`Mesh.group <avatar_tpu_torch.parallel.mesh.Mesh.group>`) where the
reference takes an axis name inside ``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import torch

from avatar_tpu_torch.ops.flash_attention import (
    LSE_MASKED,
    NEG_INF,
    _flash_backward,
    _flash_forward,
    supports,
)
from avatar_tpu_torch.parallel.collectives import (
    AxisGroup,
    all_gather,
    all_gather_plain,
    all_to_all,
    chunk_of,
    shift,
    shift_plain,
)


def ulysses_attention(
    q: torch.Tensor,  # [B, H, N/s, D]: local token shard, all heads
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: AxisGroup,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Nkv/s] local keep-mask shard
    scale: Optional[float] = None,
    attention_impl: str = "auto",
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Sequence-sharded attention; needs H % s == 0. Returns the local
    token shard of the output, [B, H, N/s, D]. ``bounded_logits`` (qk-normed
    logits) lets the local attention take the max-free kernel."""
    from avatar_tpu_torch.ops.attention import scaled_dot_product_attention

    s = axis_name.size
    assert q.shape[1] % s == 0, f"heads {q.shape[1]} not divisible by sp axis {s}"
    # [B, H, N/s, D] -> [B, H/s, N, D]
    q_full, k_full, v_full = (all_to_all(t, axis_name, 1, 2) for t in (q, k, v))
    mask_full = None
    if kv_mask is not None:
        mask_full = all_gather_plain(kv_mask, axis_name, 1)
    out = scaled_dot_product_attention(q_full, k_full, v_full, mask=mask_full, scale=scale,
                                       impl=attention_impl, bounded_logits=bounded_logits)
    return all_to_all(out, axis_name, 2, 1)


def ulysses_cross_attention(
    q: torch.Tensor,  # [B, H, Nq/s, D] token-sharded queries
    k: torch.Tensor,  # [B, H, Lkv, D] replicated kv (the caption)
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,  # [B, Lkv] replicated
    scale: Optional[float] = None,
    attention_impl: str = "auto",
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Cross-attention with replicated short kv: local attention, no
    communication."""
    from avatar_tpu_torch.ops.attention import scaled_dot_product_attention

    return scaled_dot_product_attention(q, k, v, mask=kv_mask, scale=scale,
                                        impl=attention_impl, bounded_logits=bounded_logits)


def ring_attention(
    q: torch.Tensor,  # [B, H, N/s, D]: local token shard, all heads
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: AxisGroup,
    kv_mask: Optional[torch.Tensor] = None,  # [B, N/s] local keep-mask shard
    scale: Optional[float] = None,
    bounded_logits: bool = False,
    chunk_impl: str = "auto",  # "dense" | "flash" | "auto"
) -> torch.Tensor:
    """Ring attention: the k/v shards travel s - 1 hops to the next rank
    while an online softmax merges each chunk.

    ``chunk_impl``: "dense" (f32 einsum logits per chunk), "flash"
    (:func:`ring_flash_attention`), "auto" (flash where ``supports`` takes
    the local shapes). With ``bounded_logits`` the dense path drops the
    running max (p = exp(min(s, 80))). The dense path gives a fully-masked
    row uniform attention over all keys; the flash path gives it 0."""
    s = axis_name.size
    b, h, n_local, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if chunk_impl != "dense" and (chunk_impl == "flash" or supports(q, k, v)):
        return ring_flash_attention(q, k, v, axis_name, kv_mask=kv_mask, scale=scale,
                                    bounded_logits=bounded_logits)
    qf = q.float() * scale
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    def logits_of(k_c, m_c):
        lg = torch.einsum("bhnd,bhmd->bhnm", qf, k_c.float())
        if m_c is not None:
            lg = torch.where(m_c[:, None, None, :] > 0.5, lg, neg)
        return lg

    k_c, v_c = k, v
    m_c = None if kv_mask is None else kv_mask.float()
    num = q.new_zeros((b, h, n_local, d), dtype=torch.float32)
    den = q.new_zeros((b, h, n_local), dtype=torch.float32)
    vsum = q.new_zeros((b, h, d), dtype=torch.float32)
    m_run = torch.full((b, h, n_local), NEG_INF, dtype=torch.float32, device=q.device)
    for step in range(s):
        lg = logits_of(k_c, m_c)
        if bounded_logits:
            # masked entries get exp(-1e30) == 0: fully-masked rows end with
            # num == den == 0 and take the v-sum below
            p = torch.exp(torch.clamp(lg, max=80.0))
            num = num + torch.einsum("bhnm,bhmd->bhnd", p, v_c.float())
            den = den + p.sum(-1)
            vsum = vsum + v_c.float().sum(2)
        else:
            # -1e30 (finite) sentinels keep the rescale NaN-free
            m_new = torch.maximum(m_run, lg.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(lg - m_new[..., None])
            num = num * alpha[..., None] + torch.einsum("bhnm,bhmd->bhnd", p, v_c.float())
            den = den * alpha + p.sum(-1)
            m_run = m_new
        if step < s - 1:
            k_c, v_c = shift(k_c, axis_name), shift(v_c, axis_name)
            if m_c is not None:
                m_c = shift_plain(m_c, axis_name)
    if bounded_logits:
        dead = den == 0.0
        num = torch.where(dead[..., None], vsum[:, :, None, :] / (s * k.shape[2]), num)
        den = torch.where(dead, torch.ones_like(den), den)
    return (num / den[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# Ring flash attention
# ---------------------------------------------------------------------------


def ring_flash_chunk_forward(q, k_c, v_c, m_c, acc, lse_run, scale: float, bounded: bool):
    """One hop of the ring's forward: the flash forward (kernel C, D or E)
    of the local queries against one kv chunk, merged into the running
    (acc [B, H, n, D] f32, lse [B, H, n] f32) by log-sum-exp. A chunk row
    with no kept key (lse ``LSE_MASKED``) is left out of the merge. Start
    from acc 0 and lse -1e30."""
    o_c, lse_c = _flash_forward(q, k_c, v_c, m_c, scale, bounded)
    lse_c = torch.where(lse_c >= 0.5 * LSE_MASKED, torch.full_like(lse_c, NEG_INF), lse_c)
    lse_new = torch.logaddexp(lse_run, lse_c)
    acc = (acc * torch.exp(lse_run - lse_new)[..., None]
           + o_c.float() * torch.exp(lse_c - lse_new)[..., None])
    return acc, lse_new


def ring_global_lse(lse: torch.Tensor) -> torch.Tensor:
    """The merged lse as the flash backward takes it: a row with no kept
    key anywhere gets the ``LSE_MASKED`` sentinel back, so that its
    p = exp(s - lse) is 0."""
    return torch.where(lse <= -0.5 * LSE_MASKED, torch.full_like(lse, LSE_MASKED), lse)


def ring_flash_chunk_backward(q, k_c, v_c, m_c, out, lse, g, scale: float, dq, dk, dv):
    """One hop of the ring's backward: the flash backward (kernel F, dK/dV
    and dQ) of one kv chunk against the global O and lse
    (:func:`ring_global_lse`), added to the f32 accumulators."""
    dq_c, dk_c, dv_c = _flash_backward(q, k_c, v_c, m_c, out, lse, g, scale)
    return dq + dq_c.float(), dk + dk_c.float(), dv + dv_c.float()


def _ring_flash_forward(q, k, v, kv_mask, ag: AxisGroup, scale, bounded):
    b, h, n, d = q.shape
    acc = q.new_zeros(q.shape, dtype=torch.float32)
    lse = torch.full((b, h, n), NEG_INF, dtype=torch.float32, device=q.device)
    k_c, v_c, m_c = k, v, kv_mask
    for step in range(ag.size):
        acc, lse = ring_flash_chunk_forward(q, k_c, v_c, m_c, acc, lse, scale, bounded)
        if step < ag.size - 1:
            k_c, v_c = shift_plain(k_c, ag), shift_plain(v_c, ag)
            if m_c is not None:
                m_c = shift_plain(m_c, ag)
    return acc.to(q.dtype), lse


class _RingFlash(torch.autograd.Function):
    """The ring's custom gradient: the backward is a second ring pass in
    which each kv chunk travels with its dk/dv accumulator (home complete
    after s hops) and dq accumulates in place."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, ag, scale, bounded):
        out, lse = _ring_flash_forward(q, k, v, kv_mask, ag, scale, bounded)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.ag, ctx.scale = ag, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        ag = ctx.ag
        lse = ring_global_lse(lse)
        g = g.contiguous()
        dq = q.new_zeros(q.shape, dtype=torch.float32)
        dk = k.new_zeros(k.shape, dtype=torch.float32)
        dv = v.new_zeros(v.shape, dtype=torch.float32)
        k_c, v_c, m_c = k, v, kv_mask
        for step in range(ag.size):
            dq, dk, dv = ring_flash_chunk_backward(q, k_c, v_c, m_c, out, lse, g,
                                                   ctx.scale, dq, dk, dv)
            # the accumulators travel with their chunk: after s hops home
            dk, dv = shift_plain(dk, ag), shift_plain(dv, ag)
            if step < ag.size - 1:
                k_c, v_c = shift_plain(k_c, ag), shift_plain(v_c, ag)
                if m_c is not None:
                    m_c = shift_plain(m_c, ag)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_flash_attention(
    q: torch.Tensor,  # [B, H, N/s, D]
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: AxisGroup,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    bounded_logits: bool = False,
) -> torch.Tensor:
    """Ring attention with the flash kernels per chunk
    (:func:`ring_flash_chunk_forward`, one call a hop) and a log-sum-exp
    merge; differentiable in q, k and v (:class:`_RingFlash`, kernel F a
    hop). Keeps the kernels' convention for a row with no kept key: 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _RingFlash.apply(q, k, v, kv_mask, axis_name, float(scale), bool(bounded_logits))


# ---------------------------------------------------------------------------
# The sequence-parallel DiT
# ---------------------------------------------------------------------------


def _rows(t, ag: Optional[AxisGroup], dim: int = 0):
    return t if t is None or ag is None else chunk_of(t, ag, dim)


def dit_apply_sp(
    params: dict,
    cfg,
    hidden_states: torch.Tensor,  # [B, N, C] (N % sp == 0)
    indices_grid: Optional[torch.Tensor],  # [B, 3, N]
    timestep: Optional[torch.Tensor],  # [B] or [B, N]
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_attention_mask: Optional[torch.Tensor] = None,
    *,
    mesh,
    axis: str = "sp",
    skip_layer_mask: Optional[torch.Tensor] = None,
    skip_layer_strategy=None,
    attention_impl: str = "auto",
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    remat=False,
    freqs_cis=None,
    rope_split: bool = False,
    cross_kv=None,
    sp_impl: str = "ulysses",
    data_axis: Optional[str] = None,
    timestep_tables=None,
) -> torch.Tensor:
    """Sequence-parallel ``dit_apply``: takes the full inputs (the same on
    every rank of the axis) and returns the full output [B, N, C_out].

    Each rank runs the DiT on its N/s tokens: everything but
    self-attention is token-parallel; self-attention is Ulysses
    (``sp_impl="ulysses"``, needs heads % s == 0) or the ring ("ring");
    cross-attention attends the local queries to the replicated caption
    k/v. The output's token shards are all-gathered. ``data_axis``: the
    batch shards over that mesh axis too (B % its size == 0): each rank
    runs its rows' token shard, and the rows are gathered at the end.

    Gradients: the gathers' backward is a reduce-scatter, so a loss that
    every rank computes on the full output counts once per rank of the
    axes; divide it by their size (``train/train.py`` does).
    """
    from avatar_tpu_torch.models.dit import dit_apply

    ag = mesh.group(axis)
    s = ag.size
    n = hidden_states.shape[1]
    assert n % s == 0, f"tokens {n} not divisible by sp={s}"
    if sp_impl == "ulysses":
        assert cfg.num_attention_heads % s == 0, (
            cfg.num_attention_heads, s, "heads not divisible by sp axis: use sp_impl='ring'")
    elif sp_impl != "ring":
        raise ValueError(f"unknown sp_impl {sp_impl!r}")
    dg = None
    if data_axis is not None:
        dg = mesh.group(data_axis)
        assert hidden_states.shape[0] % dg.size == 0, (
            hidden_states.shape[0], dg.size, "batch not divisible by the data axis")

    def tokens(t, dim=1):
        return None if t is None else chunk_of(_rows(t, dg), ag, dim)

    if timestep is not None:
        timestep = _rows(timestep, dg) if timestep.ndim == 1 else tokens(timestep)
    if freqs_cis is not None:
        freqs_cis = tuple(tokens(f) for f in freqs_cis)
    if cross_kv is not None:
        if torch.is_tensor(cross_kv[0]):  # stacked (k [L, B, ...], v [L, B, ...])
            cross_kv = tuple(_rows(t, dg, 1) for t in cross_kv)
        else:
            cross_kv = [tuple(_rows(t, dg) for t in kv) for kv in cross_kv]
    if timestep_tables is not None:
        timestep_tables = tuple(_rows(t, dg) for t in timestep_tables)
    out = dit_apply(
        params, cfg, tokens(hidden_states), tokens(indices_grid, 2), timestep,
        _rows(encoder_hidden_states, dg), _rows(encoder_attention_mask, dg),
        skip_layer_mask=_rows(skip_layer_mask, dg, 1),
        skip_layer_strategy=skip_layer_strategy, attention_impl=attention_impl,
        freqs_cis=freqs_cis, rope_split=rope_split, cross_kv=cross_kv,
        timestep_tables=timestep_tables, lora=lora, lora_scale=lora_scale, remat=remat,
        sp_axis=ag, sp_impl=sp_impl,
    )
    out = all_gather(out, ag, 1)
    return out if dg is None else all_gather(out, dg, 0)
