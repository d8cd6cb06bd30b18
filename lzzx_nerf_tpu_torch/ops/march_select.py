"""Block-march candidate select + first-S scan: the CUDA kernel's wrapper
(port of lzzx_nerf_tpu/ops/march_select_pallas.py) and its plain PyTorch
version.

Both compute, for every ray of every 2x2-pixel block, the lattice indices
of its first S occupied candidates (-1 where it has fewer): each candidate
k's cell from t_start + k*dt, its 5x5-neighbourhood field relative to the
(block, group) anchor, the word of the nb5w table row the anchor selects,
and the bit test gated on t < t_end, k < num_cand and the slot. The kernel
(csrc/march_select.cu) also fetches the table words itself, so neither
version materializes the [Bb*G, 50] row tensor of the JAX path.
"""

from __future__ import annotations

import torch

from .. import kernels


def march_select_reference(col_mask, gx, gy, w0, rays_o, rays_d, t_start,
                           t_end, slot_valid, bound: float, dt: float,
                           H: int, num_cand: int,
                           max_samples: int) -> torch.Tensor:
    """Plain PyTorch select (the JAX nb5w branch: word select + first-S
    selection) -> [B, S] int32, -1 where no sample."""
    B = rays_o.shape[0]
    G = gx.shape[1]
    Kp = 2 * G
    W32 = H // 32
    S = max_samples
    dev = rays_o.device
    k = torch.arange(Kp, device=dev, dtype=torch.float32)
    t_cand = t_start[:, None] + k[None] * dt                       # [B, Kp]
    pos = torch.clamp(rays_o[:, None, :] + t_cand[..., None]
                      * rays_d[:, None, :], -bound, bound)
    gp = torch.clamp(0.5 * (pos / bound + 1.0) * H, 0, H - 1).to(torch.int64)
    cx, cy, cz = gp[..., 0], gp[..., 1], gp[..., 2]

    def per_candidate(a):            # [Bb, G] anchor -> [B, Kp]
        return a.to(torch.int64).repeat_interleave(4, 0).repeat_interleave(
            2, 1)

    ax, ay, aw = per_candidate(gx), per_candidate(gy), per_candidate(w0)
    nb = ((torch.clamp(cx - ax, -2, 2) + 2) * 5
          + (torch.clamp(cy - ay, -2, 2) + 2))
    widx = torch.clamp((cz >> 5) - aw, 0, 1)
    row = (ax * H + ay) * W32 + aw
    word = col_mask.to(torch.int32)[row, nb * 2 + widx].to(torch.int64)
    occ = ((word >> (cz & 31)) & 1) > 0
    kk = torch.arange(Kp, device=dev)
    valid = (occ & (t_cand < t_end[:, None]) & slot_valid[:, None]
             & (kk < num_cand)[None])
    rank = torch.cumsum(valid.to(torch.int64), dim=1)
    keep = valid & (rank <= S)
    col = torch.where(keep, rank - 1, torch.full_like(rank, S))
    out = torch.full((B, S + 1), -1, dtype=torch.int32, device=dev)
    src = torch.where(keep, kk[None].expand(B, -1), -1).to(torch.int32)
    out.scatter_(1, col, src)                  # column S is discarded
    return out[:, :S].contiguous()


def march_select_cuda(col_mask, gx, gy, w0, rays_o, rays_d, t_start, t_end,
                      slot_valid, bound: float, dt: float, H: int,
                      num_cand: int, max_samples: int) -> torch.Tensor:
    """Launch the CUDA select kernel -> [B, S] int32 (-1 = no sample)."""
    dev = rays_o.device
    if dev.type != "cuda":
        raise ValueError("march_select_cuda takes CUDA tensors")
    B = rays_o.shape[0]
    Bb = B // 4
    G = gx.shape[1]
    W32 = H // 32
    S = max_samples
    if B % 4 or H % 32 or not 1 <= S <= 32 or 3 * G + 4 * S > 1536:
        raise ValueError(f"march_select_cuda: need B % 4 == 0, H % 32 == 0, "
                         f"1 <= S <= 32 and 3 G + 4 S <= 1536 (B={B}, H={H}, "
                         f"G={G}, S={S})")
    checks = ((col_mask, (H * H * W32, 50), torch.int32),
              (gx, (Bb, G), torch.int32), (gy, (Bb, G), torch.int32),
              (w0, (Bb, G), torch.int32),
              (rays_o, (B, 3), torch.float32),
              (rays_d, (B, 3), torch.float32),
              (t_start, (B,), torch.float32), (t_end, (B,), torch.float32),
              (slot_valid, (B,), torch.bool))
    for t, shape, dtype in checks:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"march_select_cuda: expected {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"march_select_cuda: expected a contiguous "
                             f"{shape}, got {tuple(t.shape)}")
    sel = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            kernels.launch(
                "march_select", col_mask.data_ptr(), gx.data_ptr(),
                gy.data_ptr(), w0.data_ptr(), rays_o.data_ptr(),
                rays_d.data_ptr(), t_start.data_ptr(), t_end.data_ptr(),
                slot_valid.data_ptr(), sel.data_ptr(), B, G, H,
                float(bound), float(dt), num_cand, S,
                torch.cuda.current_stream(dev).cuda_stream)
    return sel


def march_select(col_mask, gx, gy, w0, rays_o, rays_d, t_start, t_end,
                 slot_valid, bound: float, dt: float, H: int, num_cand: int,
                 max_samples: int) -> torch.Tensor:
    """First-S candidate indices [B, S] int32 (-1 where no sample).

    The kernel's wrapper: CUDA tensors run the CUDA kernel, CPU tensors
    run march_select_reference, any other device raises."""
    dev = rays_o.device
    if dev.type == "cuda":
        return march_select_cuda(
            col_mask.contiguous(), gx.to(torch.int32).contiguous(),
            gy.to(torch.int32).contiguous(), w0.to(torch.int32).contiguous(),
            rays_o.float().contiguous(), rays_d.float().contiguous(),
            t_start.float().contiguous(), t_end.float().contiguous(),
            slot_valid.to(torch.bool).contiguous(), bound, dt, H, num_cand,
            max_samples)
    if dev.type == "cpu":
        return march_select_reference(
            col_mask, gx, gy, w0, rays_o, rays_d, t_start, t_end,
            slot_valid, bound, dt, H, num_cand, max_samples)
    raise ValueError(f"no march select kernel for device {dev}")
