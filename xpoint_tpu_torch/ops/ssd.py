"""Mamba-2 SSD (state-space duality) chunked scan, fp32 (port of
``xpoint_tpu/ops/ssd.py``).

The chunked decomposition turns the per-head recurrence

    h_t = exp(dt_t * A_head) * h_{t-1} + dt_t * B_t^T x_t
    y_t = C_t h_t + D * x_t

into products inside chunks of ``chunk_size`` tokens and a short recurrence
over the chunks' final states. Shapes: x (B, L, H, P); dt (B, L, H); A (H,);
Bs / Cs (B, L, G, N), the G groups broadcast over H // G heads; D (H, P) or
None; dt_bias (H,) or None. The JAX package computes the products as
``jnp.einsum`` outside any Pallas kernel, so they are library products
here too. The intra-chunk product is contracted pairwise, C with B first,
so that its peak holds a few (B, nc, H, cs, cs) planes: the five-operand
einsum of the JAX source would otherwise be left to torch's contraction
order.
"""
import torch
import torch.nn.functional as F


def _segsum(x):
    """Stable segment sum: out[..., i, j] = sum_{j < k <= i} x[..., k],
    -inf above the diagonal. x: (..., T)."""
    T = x.shape[-1]
    csum = torch.cumsum(x, dim=-1)
    seg = csum[..., :, None] - csum[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bs, Cs, D=None, dt_bias=None, chunk_size=64,
                dt_softplus=True, initial_states=None):
    """Chunked SSD scan in fp32. Returns (y (B, L, H, P), final_state
    (B, H, P, N)). ``initial_states``: (B, 1, H, P, N) or None (zeros)."""
    Bb, L, H, P = x.shape
    G, N = Bs.shape[2], Bs.shape[3]
    reps = H // G
    L_orig = L
    f32 = torch.float32
    if L % chunk_size:
        # causal padding at the end is inert: dt = -1e9 gives softplus 0,
        # so decay exp(0) = 1 and no input contribution
        pad = chunk_size - L % chunk_size
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
        Bs = F.pad(Bs, (0, 0, 0, 0, 0, pad))
        Cs = F.pad(Cs, (0, 0, 0, 0, 0, pad))
        L += pad
    nc, cs = L // chunk_size, chunk_size

    x = x.to(f32)
    dt = dt.to(f32)
    if dt_bias is not None:
        dt = dt + dt_bias.to(f32)
    if dt_softplus:
        dt = F.softplus(dt)
    A_dt = dt * A.to(f32)                                   # (B, L, H)

    # groups broadcast to heads, then chunks
    Bh = Bs.to(f32).repeat_interleave(reps, dim=2)          # (B, L, H, N)
    Ch = Cs.to(f32).repeat_interleave(reps, dim=2)
    xc = x.reshape(Bb, nc, cs, H, P)
    dtc = dt.reshape(Bb, nc, cs, H)
    Ac = A_dt.reshape(Bb, nc, cs, H).permute(0, 3, 1, 2)    # (B, H, nc, cs)
    Bc = Bh.reshape(Bb, nc, cs, H, N)
    Cc = Ch.reshape(Bb, nc, cs, H, N)
    A_cumsum = torch.cumsum(Ac, dim=-1)                     # (B, H, nc, cs)

    # 1. intra-chunk (diagonal block) outputs:
    # einsum("bclhn,bcshn,bhcls,bcsh,bcshp->bclhp"), pairwise
    Lmat = torch.exp(_segsum(Ac)).permute(0, 2, 1, 3, 4)   # (B,nc,H,cs,cs)
    scores = (torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * Lmat
              * dtc.permute(0, 1, 3, 2)[:, :, :, None, :])
    del Lmat
    Y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)
    del scores

    # 2. chunk-final intra-chunk states
    decay_states = torch.exp(A_cumsum[..., -1:] - A_cumsum)  # (B, H, nc, cs)
    w = decay_states.permute(0, 2, 3, 1) * dtc               # (B, nc, cs, H)
    states = torch.einsum("bclhn,bclhp->bchpn", Bc, xc * w[..., None])

    # 3. inter-chunk recurrence over the chunk states
    if initial_states is None:
        initial_states = torch.zeros(Bb, 1, H, P, N, dtype=f32,
                                     device=x.device)
    states = torch.cat([initial_states.to(f32), states], dim=1)
    chunk_decay = F.pad(A_cumsum[..., -1], (1, 0))           # (B, H, nc+1)
    decay_chunk = torch.exp(_segsum(chunk_decay))            # (B,H,nc+1,nc+1)
    decay_chunk = torch.where(torch.isfinite(decay_chunk), decay_chunk,
                              torch.zeros((), dtype=f32, device=x.device))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output per chunk
    state_decay_out = torch.exp(A_cumsum)                    # (B, H, nc, cs)
    Y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, states) \
        * state_decay_out.permute(0, 2, 3, 1)[..., None]

    y = (Y_diag + Y_off).reshape(Bb, L, H, P)
    if D is not None:
        y = y + D.to(f32)[None, None] * x
    return y[:, :L_orig], final_state
