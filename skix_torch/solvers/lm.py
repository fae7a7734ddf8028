"""Matrix-free Levenberg–Marquardt on ``torch.func``.

Port of ``skix/solvers/lm.py``: Gauss–Newton with Jacobian products from
``torch.func.vjp`` (JᵀJ is never formed), a fixed-iteration
conjugate-gradient solve of the damped normal equations

    (JᵀJ + λ·diag(JᵀJ)) δ = −Jᵀr,

and the same trust-region λ schedule. Jv is the vjp of the linear map
u ↦ Jᵀu, built once per step and reused by every CG iteration: the same
linear map as ``torch.func.jvp`` gives, without a forward-mode pass per
product, which costs far more in eager PyTorch. ``diag(JᵀJ)`` is a
Hutchinson estimate over Rademacher probes. skix draws them from
``jax.random.PRNGKey(17)``, a stream torch cannot reproduce; here they
come from a ``torch.Generator`` seeded 17, so the two solvers agree on
converged quantities, not step by step. The loop runs in Python; each
step reads one flag back to decide whether to stop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import vjp, vmap


class LMResult(NamedTuple):
    x: torch.Tensor             # final parameters (flat)
    cost: torch.Tensor          # final ½‖r‖²
    initial_cost: torch.Tensor
    iterations: int             # accepted + rejected steps taken
    lam: torch.Tensor           # final damping


def _cg_solve(matvec: Callable, b, x0, iters: int):
    """Fixed-iteration conjugate gradient for an SPD ``matvec``."""
    x = x0
    r = b - matvec(x0)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rs / torch.where(denom <= 0, 1e-30, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        beta = rs_new / torch.where(rs <= 0, 1e-30, rs)
        p = r + beta * p
        rs = rs_new
    return x


def rademacher_probes(probes: int, n: int, dtype, device,
                      seed: int = 17) -> torch.Tensor:
    """``(probes, n)`` ±1 draws from a generator seeded ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    bits = torch.randint(0, 2, (probes, n), generator=g)
    return (2 * bits - 1).to(dtype=dtype, device=device)


def _linearize(residual_fn: Callable, x, r):
    """``(g, jtv, jv)`` at ``x``: the gradient ``Jᵀr`` and the maps
    ``u ↦ Jᵀu`` and ``v ↦ Jv``. ``jv`` is the vjp of the linear map
    ``jtv``, so it needs no forward-mode pass."""
    _, vjp_fn = vjp(residual_fn, x)

    def jtv(u):
        return vjp_fn(u)[0]

    _, jv_fn = vjp(jtv, r)

    def jv(v):
        return jv_fn(v)[0]

    return jtv(r), jtv, jv


def _estimate_jtj_diag(jtv: Callable, jv: Callable, x, probes: int):
    """Hutchinson estimate of ``diag(JᵀJ)``: E[v ⊙ JᵀJv] over Rademacher
    probes ``v``."""
    vs = rademacher_probes(probes, x.numel(), x.dtype, x.device)
    return vmap(lambda v: v * jtv(jv(v)))(vs).mean(dim=0)


def levenberg_marquardt(
    residual_fn: Callable,
    x0: torch.Tensor,
    args: tuple = (),
    max_steps: int = 50,
    cg_iters: int = 30,
    init_lambda: float = 1e-3,
    lambda_up: float = 3.0,
    lambda_down: float = 3.0,
    rtol: float = 1e-8,
    damping_scale=None,
    diag_probes: int = 8,
) -> LMResult:
    """Minimize ``½‖residual_fn(x, *args)‖²`` over a flat parameter vector.

    Damping is Marquardt-scaled; ``damping_scale`` supplies the diagonal,
    else it is re-estimated every step from ``diag_probes`` Hutchinson
    probes (floored so zero-column parameters still get identity damping).
    """
    x0 = x0.detach()

    def rfn(x):
        return residual_fn(x, *args)

    def cost_of(x):
        r = rfn(x)
        return 0.5 * torch.dot(r, r)

    x = x0
    lam = torch.tensor(init_lambda, dtype=x0.dtype, device=x0.device)
    cost = c0 = cost_of(x0)
    it = 0
    while it < max_steps:
        g, jtv, jv = _linearize(rfn, x, rfn(x))       # g = Jᵀ r
        if damping_scale is None:
            diag = _estimate_jtj_diag(jtv, jv, x, diag_probes)
        else:
            diag = torch.as_tensor(damping_scale, dtype=x.dtype,
                                   device=x.device)
        diag = torch.maximum(diag, 1e-6 * diag.max() + 1e-12)

        def matvec(v, jtv=jtv, jv=jv, lam=lam, diag=diag):
            return jtv(jv(v)) + lam * diag * v

        delta = _cg_solve(matvec, -g, torch.zeros_like(x), cg_iters)
        x_new = x + delta
        new_cost = cost_of(x_new)
        improved = new_cost < cost
        x = torch.where(improved, x_new, x)
        lam = torch.where(improved, lam / lambda_down, lam * lambda_up)
        lam = lam.clamp(1e-12, 1e12)
        rel_impr = (cost - new_cost) / (cost + 1e-30)
        done = improved & (rel_impr < rtol)
        cost = torch.where(improved, new_cost, cost)
        it += 1
        if bool(done):
            break
    return LMResult(x=x, cost=cost, initial_cost=c0, iterations=it, lam=lam)
