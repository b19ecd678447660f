"""Plain float32 Mamba2 (state-spaces/mamba_ssm's MambaLMHeadModel with
Mamba2 mixers), in the chunked form of the SSD paper's minimal listing
(Dao & Gu 2024, "ssd_minimal_discrete") and as the one-step recurrence.

Weights (the benchmark's draw):

  embed (V, d), unembed (d, V) (tied: the embedding's transpose),
  final_norm (d,); ln (L, d); in_proj (L, d, 2·di + 2·N + H) packed
  z | x | B | C | dt; conv_w (L, K, di + 2·N); A_log, D, dt_bias (L, H);
  norm (L, di); out_proj (L, di, d)

A layer: h = rmsnorm(x); z, xBC, dt = h·in_proj; xBC = silu(causal
depthwise conv(xBC)); x, B, C = xBC; dt = softplus(dt + dt_bias); A =
-exp(A_log); y = SSD(x, dt, A, B, C) + D·x; y = rmsnorm(y·silu(z)) (the
gated norm, norm after the gate); x += y·out_proj.  One group (B and C
shared by every head); no conv bias (the port has none).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from bench.reference.common import exact_float32, mm, rmsnorm


def dims(cfg: Dict) -> Dict[str, int]:
    d = cfg["d_model"]
    di = cfg["expand"] * d
    return {"L": cfg["n_layer"], "d": d, "di": di, "N": cfg["d_state"],
            "P": cfg["headdim"], "H": di // cfg["headdim"],
            "K": cfg["d_conv"], "chunk": cfg["chunk_size"]}


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) → (..., T, T): [i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal (the stable form: masked, then summed)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t).clone()   # x[..., i, j] = a[i]
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device),
                       -1)
    x = x.masked_fill(~below, 0.0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return out.masked_fill(~diag, -torch.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int) -> torch.Tensor:
    """One sequence: x (S, H, P), dt (S, H), A (H,), B and C (S, N) → y (S,
    H, P): h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t, y_t = h_t · C_t,
    from a zero state, computed chunk by chunk."""
    s, h, p = x.shape
    c, l = s // chunk, chunk
    X = (x * dt[..., None]).reshape(c, l, h, p)
    a = (dt * A).reshape(c, l, h).permute(2, 0, 1)         # (H, c, l)
    Bc, Cc = B.reshape(c, l, -1), C.reshape(c, l, -1)
    a_cum = torch.cumsum(a, dim=-1)
    # within each chunk
    decay = torch.exp(segsum(a))                           # (H, c, l, l)
    cb = Cc @ Bc.transpose(1, 2)                           # (c, l, s)
    y_diag = (decay * cb[None]) @ X.permute(2, 0, 1, 3)    # (H, c, l, P)
    # each chunk's final state, then the states entering each chunk
    w = torch.exp(a_cum[..., -1:] - a_cum)                 # (H, c, l)
    states = torch.einsum("cln,hcl,clhp->chpn", Bc, w, X)
    states = torch.cat([torch.zeros_like(states[:1]), states])
    carry = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # (H, c+1, c+1)
    entering = torch.einsum("hzc,chpn->zhpn", carry, states)[:-1]
    y_off = torch.einsum("cln,chpn,hcl->clhp", Cc, entering, torch.exp(a_cum))
    return (y_diag.permute(1, 2, 0, 3) + y_off).reshape(s, h, p)


def _split(cfg: Dict, W: Dict, i: int, h: torch.Tensor, mode: str):
    n = dims(cfg)
    zxbcdt = mm(h, W["in_proj"][i], mode)
    return torch.split(zxbcdt, [n["di"], n["di"] + 2 * n["N"], n["H"]], -1)


def _gate_out(cfg: Dict, W: Dict, i: int, y: torch.Tensor, z: torch.Tensor,
              mode: str) -> torch.Tensor:
    y = rmsnorm(y * F.silu(z), W["norm"][i], cfg["rms_norm_eps"])
    return mm(y, W["out_proj"][i], mode)


def mixer(W: Dict, cfg: Dict, i: int, h: torch.Tensor,
          mode: str) -> torch.Tensor:
    """Layer ``i``'s Mamba2 mixer on one sequence h (S, d) → (S, d)."""
    n = dims(cfg)
    s = h.shape[0]
    z, xbc, dt = _split(cfg, W, i, h, mode)
    w = W["conv_w"][i].float()                             # (K, C)
    pad = F.pad(xbc, (0, 0, n["K"] - 1, 0))
    conv = sum(pad[j:j + s] * w[j] for j in range(n["K"]))
    xbc = F.silu(conv)
    xs, B, C = torch.split(xbc, [n["di"], n["N"], n["N"]], -1)
    dt = F.softplus(dt + W["dt_bias"][i].float())
    A = -torch.exp(W["A_log"][i].float())
    xh = xs.view(s, n["H"], n["P"])
    y = ssd(xh, dt, A, B, C, n["chunk"]) \
        + W["D"][i].float()[:, None] * xh
    return _gate_out(cfg, W, i, y.reshape(s, -1), z, mode)


def prefill_last_logits(W: Dict, cfg: Dict, tokens: torch.Tensor,
                        mode: str = "f32") -> torch.Tensor:
    """tokens (B, S), S a multiple of the chunk → the last position's
    logits (B, V), float32; one sequence at a time."""
    eps = cfg["rms_norm_eps"]
    rows = []
    with exact_float32():
        for seq in tokens:
            x = W["embed"][seq].float()
            for i in range(cfg["n_layer"]):
                x = x + mixer(W, cfg, i, rmsnorm(x, W["ln"][i], eps), mode)
            rows.append(mm(rmsnorm(x[-1:], W["final_norm"], eps),
                           W["unembed"], mode))
    return torch.cat(rows)


def init_state(cfg: Dict, batch: int, device) -> Dict[str, torch.Tensor]:
    """The recurrence's zero state: each layer's conv window (B, K-1, C)
    and SSM state (B, H, P, N), float32."""
    n = dims(cfg)
    return {"conv": torch.zeros(n["L"], batch, n["K"] - 1,
                                n["di"] + 2 * n["N"], device=device),
            "ssm": torch.zeros(n["L"], batch, n["H"], n["P"], n["N"],
                               device=device)}


def decode_step(W: Dict, cfg: Dict, tokens: torch.Tensor,
                state: Dict[str, torch.Tensor], mode: str = "f32"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token of B sequences through the recurrence: tokens (B,) →
    (logits (B, V), the new state)."""
    n = dims(cfg)
    eps = cfg["rms_norm_eps"]
    conv_s, ssm_s = state["conv"].clone(), state["ssm"].clone()
    with exact_float32():
        x = W["embed"][tokens].float()
        b = x.shape[0]
        for i in range(n["L"]):
            z, xbc, dt = _split(cfg, W, i, rmsnorm(x, W["ln"][i], eps), mode)
            window = torch.cat([conv_s[i], xbc[:, None]], dim=1)  # (B, K, C)
            conv_s[i] = window[:, 1:]
            xbc = F.silu((window * W["conv_w"][i].float()).sum(1))
            xs, B, C = torch.split(xbc, [n["di"], n["N"], n["N"]], -1)
            dt = F.softplus(dt + W["dt_bias"][i].float())          # (B, H)
            A = -torch.exp(W["A_log"][i].float())
            xh = xs.view(b, n["H"], n["P"])
            ssm_s[i] = ssm_s[i] * torch.exp(dt * A)[..., None, None] \
                + (xh * dt[..., None])[..., None] * B[:, None, None]
            y = (ssm_s[i] @ C[:, None, :, None])[..., 0] \
                + W["D"][i].float()[:, None] * xh
            x = x + _gate_out(cfg, W, i, y.reshape(b, -1), z, mode)
        logits = mm(rmsnorm(x, W["final_norm"], eps), W["unembed"], mode)
    return logits, {"conv": conv_s, "ssm": ssm_s}
