"""Sim(3) pose-graph optimisation, the loop-closure back end (the
counterpart of ``simpleslam_tpu/ops/pgo.py``).

  * Nodes: keyframe camera-from-world similarities ``S_iw = (R, t, s)``.
  * Edges: relative measurements ``M_ij ~ S_iw o S_jw^-1``: the odometry
    chain plus the loop edges of ``ops/sim3.sim3_ransac_3d3d``.
  * Residual: ``r_e = log(M_ij^-1 o S_i o S_j^-1)`` in R^7 with Huber
    weights; the per-edge 7x7 Jacobians with respect to each endpoint's left
    tangent perturbation come from ``torch.func.jacfwd`` under
    ``torch.func.vmap`` over the edges.
  * Assembly: one-hot matrix products (the reference's form), a dense
    damped (7K, 7K) system and a Cholesky solve (``cholesky_ex``, no status
    check). Gauge: ``node_free = False`` pins a node.

The Levenberg-Marquardt loop is a Python loop over device tensors; its
stopping test reads one flag per iteration (the solve is off the per-frame
path).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from simpleslam_tpu_torch.ops import sim3
from simpleslam_tpu_torch.ops.sim3 import Sim3
from simpleslam_tpu_torch.utils.precision import highest_precision

_EPS = 1e-12


class PGOProblem(NamedTuple):
    """Padded pose-graph problem.

    nodes:     Sim3 with batch dim K, the initial camera-from-world nodes.
    edge_i/j:  (E,) int64 endpoint indices.
    meas:      Sim3 with batch dim E, relative measurements M_ij.
    e_valid:   (E,) bool live edges.
    e_weight:  (E,) float32 per-edge weight.
    node_free: (K,) bool; False pins a node (gauge).
    """
    nodes: Sim3
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    meas: Sim3
    e_valid: torch.Tensor
    e_weight: torch.Tensor
    node_free: torch.Tensor


def _edge_residual(Minv: Sim3, Si: Sim3, Sj: Sim3, di: torch.Tensor,
                   dj: torch.Tensor) -> torch.Tensor:
    """r = log(M^-1 o (exp(di) Si) o (exp(dj) Sj)^-1), (7,)."""
    Si_p = sim3.compose(sim3.exp(di), Si)
    Sj_p = sim3.compose(sim3.exp(dj), Sj)
    return sim3.log(sim3.compose(Minv, sim3.compose(Si_p,
                                                    sim3.inverse(Sj_p))))


def _huber_w(rnorm: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(rnorm <= delta, torch.ones_like(rnorm),
                       delta / torch.clamp(rnorm, min=_EPS))


def _robust_cost(r: torch.Tensor, w_e: torch.Tensor, delta: float
                 ) -> torch.Tensor:
    s = (r * r).sum(-1)
    n = torch.sqrt(torch.clamp(s, min=0.0))
    rho = torch.where(n <= delta, s, 2.0 * delta * n - delta * delta)
    return (w_e * rho).sum()


def _gather(S: Sim3, idx: torch.Tensor) -> Sim3:
    return Sim3(*(x.index_select(0, idx) for x in S))


@highest_precision()
def pgo_solve(problem: PGOProblem, *, huber: float = 1.0,
              max_iters: int = 20, init_lambda: float = 1e-4):
    """LM over the Sim(3) pose graph on the device of ``problem``.
    Returns (nodes, cost_initial, cost_final, n_good_iters), the costs
    0-d tensors, ``n_good_iters`` an int."""
    f32 = torch.float32
    K = problem.nodes.s.shape[0]
    ei, ej = problem.edge_i.long(), problem.edge_j.long()
    dev = ei.device
    w_edge = problem.e_weight.to(f32) * problem.e_valid.to(f32)
    free = problem.node_free
    free_f = free.to(f32)
    Minv = sim3.inverse(Sim3(*(x.to(f32) for x in problem.meas)))
    zero7 = torch.zeros(7, dtype=f32, device=dev)

    def one_edge(mR, mt, ms, iR, it, is_, jR, jt, js):
        def f(di, dj):
            return _edge_residual(Sim3(mR, mt, ms), Sim3(iR, it, is_),
                                  Sim3(jR, jt, js), di, dj)
        Ji, Jj = jacfwd(f, argnums=(0, 1))(zero7, zero7)
        return f(zero7, zero7), Ji, Jj

    def residuals(nodes: Sim3) -> torch.Tensor:
        return _edge_residual(Minv, _gather(nodes, ei), _gather(nodes, ej),
                              zero7, zero7)

    def cost_of(nodes: Sim3) -> torch.Tensor:
        r = residuals(nodes)
        r = torch.where(torch.isfinite(r), r, torch.full_like(r, 1e3))
        return _robust_cost(r, w_edge, huber)

    ar = torch.arange(K, device=dev)
    oh_i = (ei[:, None] == ar[None, :]).to(f32)            # (E, K)
    oh_j = (ej[:, None] == ar[None, :]).to(f32)
    free7 = free.repeat_interleave(7)
    pin = free7[:, None] & free7[None, :]

    def lm_step(nodes: Sim3, lam: torch.Tensor):
        Si, Sj = _gather(nodes, ei), _gather(nodes, ej)
        r, Ji, Jj = vmap(one_edge)(*Minv, *Si, *Sj)
        r, Ji, Jj = r.to(f32), Ji.to(f32), Jj.to(f32)
        bad = ~torch.isfinite(r).all(-1)
        r = torch.where(bad[:, None], torch.zeros_like(r), r)
        Ji = torch.where(bad[:, None, None], torch.zeros_like(Ji), Ji)
        Jj = torch.where(bad[:, None, None], torch.zeros_like(Jj), Jj)
        w = w_edge * _huber_w(torch.linalg.norm(r, dim=-1), huber)
        Ji = Ji * free_f[ei][:, None, None]
        Jj = Jj * free_f[ej][:, None, None]
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        Hii = (oh_i.T @ torch.einsum("eri,erj->eij", wJi, Ji).reshape(-1, 49)
               ).reshape(K, 7, 7)
        Hjj = (oh_j.T @ torch.einsum("eri,erj->eij", wJj, Jj).reshape(-1, 49)
               ).reshape(K, 7, 7)
        cross = torch.einsum("eri,erj->eij", wJi, Jj).reshape(-1, 49)
        Zij = (oh_j[:, :, None] * cross[:, None, :]).reshape(-1, K * 49)
        Hij = (oh_i.T @ Zij).reshape(K, K, 7, 7)
        H = Hij + Hij.permute(1, 0, 3, 2)
        H[ar, ar] += Hii + Hjj
        g = -(oh_i.T @ torch.einsum("eri,er->ei", wJi, r)
              + oh_j.T @ torch.einsum("eri,er->ei", wJj, r))     # (K, 7)

        Hm = H.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hm = Hm + torch.diag(lam * torch.diagonal(Hm) + 1e-8)
        Hm = torch.where(pin, Hm, torch.zeros_like(Hm))
        Hm = Hm + torch.diag((~free7).to(f32))
        gv = torch.where(free7, g.reshape(-1), torch.zeros_like(free7,
                                                                dtype=f32))
        L, _info = torch.linalg.cholesky_ex(Hm)
        y = torch.linalg.solve_triangular(L, gv[:, None], upper=False)
        dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
        dx = dx.reshape(K, 7) * free_f[:, None]

        nodes_new = sim3.compose(sim3.exp(dx), nodes)
        c_old, c_new = cost_of(nodes), cost_of(nodes_new)
        accept = (c_new < c_old) & torch.isfinite(c_new)
        nodes = Sim3(*(torch.where(accept, a, b)
                       for a, b in zip(nodes_new, nodes)))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                          torch.clamp(lam * 4.0, max=1e6))
        return nodes, lam, accept, c_old, c_new

    nodes = Sim3(*(x.to(f32) for x in problem.nodes))
    c0 = cost_of(nodes)
    lam = torch.full((), init_lambda, dtype=f32, device=dev)
    n_good = n_rej = 0
    for _ in range(max_iters):
        nodes, lam, accept, c_before, c_after = lm_step(nodes, lam)
        rel = (c_before - c_after) / torch.clamp(c_before, min=1e-12)
        # the one read of an iteration: (accepted, converged)
        acc, conv = torch.stack([accept, accept & (rel < 1e-7)]).tolist()
        n_good += acc
        n_rej = 0 if acc else n_rej + 1
        if n_rej >= 3 or conv:
            break
    return nodes, c0, cost_of(nodes), n_good


def sequential_edges(nodes: Sim3) -> tuple:
    """Odometry chain measurements M_{i+1,i} = S_{i+1} o S_i^-1 from the
    current node estimates. Returns (edge_i, edge_j, meas) with
    edge_i = k + 1, edge_j = k."""
    K = nodes.s.shape[0]
    dev = nodes.s.device
    i = torch.arange(1, K, device=dev)
    j = torch.arange(0, K - 1, device=dev)
    return i, j, sim3.compose(_gather(nodes, i),
                              sim3.inverse(_gather(nodes, j)))
