"""GMRES(m) with restarts: Arnoldi by Gram-Schmidt, then a Givens solve.

Port of ``legionsolvers_tpu/solvers/gmres.py`` (reference:
GMRESSolver.hpp:15-129).  The workspace holds the restart + 1 Krylov basis
vectors at planner indices ``krylov_basis(i) = i + 2``.  :meth:`step` is the
reference's transcription: modified Gram-Schmidt with the Hessenberg
entries carried as deferred scalars, the last basis vector left
unnormalized.  The reference stubs the least-squares update (a constant-1
future, GMRESSolver.hpp:109-126); here, as in the JAX package, the small
(m+1) x m Hessenberg system is solved for real with Givens rotations on the
device (:func:`_least_squares_givens`), O(m^2) scalar operations.

:meth:`solve` runs a single-space, single-operator system on the batched
CGS2 runner (:meth:`_make_fused_runner`): the basis lives in one (m+1, n)
tensor and each Arnoldi step's projections and rank updates are
``torch.matmul`` on the flattened basis, as the JAX package leaves them to
XLA.  Those products are held at full float32 (no TF32) whatever the
caller enabled.  The operator's matvec is its kernel (K3 ``y`` on the 2-D
view, K6a on the 3-D one).  No step reads a scalar back to the host.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

from ..core.scalar import Scalar, ScalarHistory
from ..planner import SquarePlanner


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 cuBLAS products at full precision (no TF32) inside the
    block; the caller's setting comes back on the way out, whichever of
    torch's two switches set it.  torch refuses to read a state set
    through a mix of ``allow_tf32`` and ``fp32_precision``, so the block
    sets the older flag, which sets both, and the exit restores both."""
    matmul = torch.backends.cuda.matmul
    if not hasattr(matmul, "fp32_precision"):
        saved = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = saved
        return
    saved = matmul.fp32_precision
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved == "tf32"
        if saved != "tf32":
            matmul.fp32_precision = saved


def _least_squares_givens(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """min_y || beta e1 - H y ||_2 for the (m+1) x m Hessenberg ``H`` by
    Givens rotations and back-substitution.  Zero subdiagonals (lucky
    breakdown) and zero diagonals (stagnation) are guarded with
    ``torch.where``, so the result stays finite without a host read."""
    m = H.shape[1]
    R = H.clone()
    g = torch.zeros(m + 1, dtype=H.dtype, device=H.device)
    g[0] = beta
    for i in range(m):
        a, b = R[i, i], R[i + 1, i]
        denom = torch.sqrt(a * a + b * b)
        safe = denom > 0
        d = torch.where(safe, denom, torch.ones_like(denom))
        c = torch.where(safe, a / d, torch.ones_like(a))
        s = torch.where(safe, b / d, torch.zeros_like(b))
        row_i = c * R[i] + s * R[i + 1]
        row_i1 = -s * R[i] + c * R[i + 1]
        R[i], R[i + 1] = row_i, row_i1
        gi = c * g[i] + s * g[i + 1]
        gi1 = -s * g[i] + c * g[i + 1]
        g[i], g[i + 1] = gi, gi1
    y = torch.zeros(m, dtype=H.dtype, device=H.device)
    for i in range(m - 1, -1, -1):
        resid = (g[i] - torch.dot(R[i, i + 1:], y[i + 1:]) if i + 1 < m
                 else g[i])
        diag = R[i, i]
        nz = diag.abs() > 0
        y[i] = torch.where(nz, resid / torch.where(nz, diag,
                                                   torch.ones_like(diag)),
                           torch.zeros_like(diag))
    return y


class GMRESSolver:
    SOL = 0
    RHS = 1

    def __init__(self, planner: SquarePlanner, restart: int):
        self.planner = planner
        self.restart = int(restart)
        planner.allocate_workspace(self.restart + 1)
        self.reset()

    def krylov_basis(self, i: int) -> int:
        """reference: GMRESSolver.hpp:80-82."""
        return i + 2

    def _zero(self) -> Scalar:
        planner = self.planner
        return Scalar(torch.zeros((), dtype=planner.options.entry_dtype,
                                  device=planner.device))

    def reset(self) -> None:
        """Clear the recorded Hessenberg and residual state (every cycle
        re-derives the rest from sol and rhs)."""
        self.inner_products: List[List[Scalar]] = [
            [self._zero()] * self.restart for _ in range(self.restart + 1)]
        self.residual_norm_squared: List[Scalar] = []

    def step(self) -> None:
        """One GMRES(m) cycle: residual, Arnoldi by modified Gram-Schmidt,
        least-squares update (reference: GMRESSolver.hpp:84-127, with the
        real solve)."""
        planner = self.planner
        kb = self.krylov_basis
        m = self.restart

        # residual r = b - A x in basis slot 0
        planner.matvec(kb(0), self.SOL)
        planner.xpay(kb(0), Scalar(-1.0), self.RHS)
        beta2 = planner.dot(kb(0), kb(0))
        self.residual_norm_squared.append(beta2)
        planner.scal(kb(0), beta2.rsqrt())

        H = torch.zeros((m + 1, m), dtype=planner.options.entry_dtype,
                        device=planner.device)
        for j in range(m):
            planner.matvec(kb(j + 1), kb(j))
            for k in range(j + 1):
                h = planner.dot(kb(k), kb(j + 1))
                self.inner_products[k][j] = h
                H[k, j] = h.value
                planner.axpy(kb(j + 1), -h, kb(k))
            d = planner.dot(kb(j + 1), kb(j + 1))
            h_last = d.sqrt()
            self.inner_products[j + 1][j] = h_last
            H[j + 1, j] = h_last.value
            if j + 1 < m:
                # lucky breakdown: a zero vector stays zero
                safe = d.value > 0
                scale = torch.where(
                    safe, torch.rsqrt(torch.where(safe, d.value,
                                                  torch.ones_like(d.value))),
                    torch.zeros_like(d.value))
                planner.scal(kb(j + 1), Scalar(scale))

        y = _least_squares_givens(H, beta2.sqrt().value)
        for j in range(m):
            planner.axpy(self.SOL, Scalar(y[j]), kb(j))

    def _make_fused_runner(self):
        """Batched-basis GMRES(m) for a single-space, single-operator
        system, else None: CGS2 (classical Gram-Schmidt applied twice), all
        j+1 projection coefficients from one ``V @ w`` product and the
        update one rank-(j+1) ``h @ V`` product.  CGS2 equals MGS up to
        rounding for well-conditioned bases ("twice is enough", Giraud et
        al. 2005).

        ``run(x, b, num_cycles) -> (x, V, H, history)``: one (m+1)-row
        basis buffer serves every cycle, so V and H are the final cycle's;
        x is a new tensor."""
        planner = self.planner
        if (planner.num_spaces != 1
                or len(planner.row_partitioned_matrices) != 1):
            return None
        op, di, ri = planner.row_partitioned_matrices[0]
        if di != 0 or ri != 0:
            return None
        m = self.restart

        def run(x, b, num_cycles):
            shape, dtype = x.shape, x.dtype
            V = torch.zeros((m + 1,) + tuple(shape), dtype=dtype,
                            device=x.device)
            Vf = V.view(m + 1, -1)
            H = torch.zeros((m + 1, m), dtype=dtype, device=x.device)
            history = torch.empty(num_cycles, dtype=dtype, device=x.device)
            for i in range(num_cycles):
                r = b - op.matvec(x)
                beta2 = torch.dot(r.reshape(-1), r.reshape(-1))
                history[i] = beta2
                pos = beta2 > 0
                inv_norm = torch.where(
                    pos, torch.rsqrt(torch.where(pos, beta2,
                                                 torch.ones_like(beta2))),
                    torch.zeros_like(beta2))
                torch.mul(r, inv_norm, out=V[0])
                H.zero_()
                for j in range(m):
                    w = op.matvec(V[j]).reshape(-1)
                    basis = Vf[: j + 1]
                    h1 = torch.matmul(basis, w)
                    w = w - torch.matmul(h1, basis)
                    h2 = torch.matmul(basis, w)
                    w = w - torch.matmul(h2, basis)
                    d = torch.dot(w, w)
                    H[: j + 1, j] = h1 + h2
                    H[j + 1, j] = torch.sqrt(d)
                    pos = d > 0
                    scale = torch.where(
                        pos, torch.rsqrt(torch.where(pos, d,
                                                     torch.ones_like(d))),
                        torch.zeros_like(d))
                    torch.mul(w, scale, out=Vf[j + 1])
                y = _least_squares_givens(H, torch.sqrt(beta2))
                x = x + torch.matmul(y, Vf[:m]).reshape(shape)
            return x, V, H, history

        return run

    def solve(self, num_cycles: int, fused: bool = True) -> torch.Tensor:
        """Run ``num_cycles`` restart cycles; returns the ||r||^2 measured
        at the start of each cycle plus the final residual (length
        num_cycles + 1) as a device tensor.  ``fused=False`` loops over the
        MGS :meth:`step` instead of the CGS2 runner.

        Observable state afterwards is the same on both paths: basis slots
        1..m hold the final cycle's Krylov basis, ``inner_products`` its
        Hessenberg entries and slot 0 the closing unnormalized residual;
        the last slot is normalized on the CGS2 path only (the MGS
        transcription never rescales it, GMRESSolver.hpp:92-107)."""
        self.planner.to_solver_basis()
        try:
            with full_f32_matmul():
                return self._solve_in_basis(num_cycles, fused)
        finally:
            self.planner.from_solver_basis()

    def _solve_in_basis(self, num_cycles: int, fused: bool) -> torch.Tensor:
        planner = self.planner
        m = self.restart
        frun = self._make_fused_runner() if fused and num_cycles >= 1 else None
        if frun is not None:
            xv = planner.get_vector(self.SOL, 0)
            bv = planner.get_vector(self.RHS, 0)
            x_new, V, H, history = frun(xv.data, bv.data, num_cycles)
            xv.data = x_new
            for i in range(1, m + 1):
                planner.get_vector(self.krylov_basis(i), 0).data = V[i]
            self.inner_products = [ScalarHistory(H[k]) for k in range(m + 1)]
            self.residual_norm_squared = ScalarHistory(history)
            op = planner.row_partitioned_matrices[0][0]
            r = bv.data - op.matvec(x_new)
            planner.get_vector(self.krylov_basis(0), 0).data = r
            rr_final = torch.dot(r.reshape(-1), r.reshape(-1))
            return torch.cat([history, rr_final.reshape(1)])

        dtype = planner.options.entry_dtype
        history = torch.empty(num_cycles, dtype=dtype, device=planner.device)
        for i in range(num_cycles):
            self.residual_norm_squared = []
            self.step()
            history[i] = self.residual_norm_squared[0].value
        self.inner_products = [
            ScalarHistory(torch.stack([s.value for s in row]).to(dtype))
            for row in self.inner_products]
        self.residual_norm_squared = ScalarHistory(history)
        # closing residual after the last cycle
        planner.matvec(self.krylov_basis(0), self.SOL)
        planner.xpay(self.krylov_basis(0), Scalar(-1.0), self.RHS)
        rr_final = planner.dot(self.krylov_basis(0), self.krylov_basis(0))
        return torch.cat([history, rr_final.value.reshape(1)])
