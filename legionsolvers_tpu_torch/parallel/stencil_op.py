"""Matrix-free stencil operator, single device.

Port of the single-device 2-D and 3-D parts of
``legionsolvers_tpu/parallel/stencil_op.py``.  A stencil matrix is exactly
banded, so ``matvec`` needs no stored matrix.  Two paths, chosen when the
operator is built:

* **kernel view** (``_view``, f32, one piece): 2-D grids (kind ``2d``, the
  ``[R, C]`` grid, kernels of ``ops/cuda/stencil2d.py`` and
  ``bicgstab2d.py``) and 3-D grids (kind ``3d``, the ``[X, Y, Z]`` volume,
  kernels of ``ops/cuda/stencil3d.py`` and ``bicgstab3d.py``).  Every pass
  is a hand-written CUDA kernel (its plain PyTorch version on CPU tensors).
  The names ``_plan_pallas_view``/``_pallas_local``/``uses_pallas`` are
  kept from the JAX package for parity.
* **linearized path** (any dimension and dtype, and 3-D stencils beyond
  the kernels' reach): shifted 1-D slices with integer-computed boundary
  masks, in torch.

The fused runners drive the whole loop.  CG (``make_fused_cg_runner``):
the s-step schedule (one K1 pass per two iterations, 2-D), the two-pass
schedule (K4 + K3 ``update`` in 2-D, K6b + K6a ``update`` in 3-D) and the
torch recompute runner.  BiCGStab (``make_fused_bicgstab_runner``): the
three K5 (2-D) or K7 (3-D) passes per iteration.  Scalars stay on the
device throughout; no runner reads one back to the host.

Not ported yet: sharding (a mesh raises; ``_exchange_planes3d`` keeps the
JAX package's name and gives zero planes on one device), the 1-D
flat-offset view, and the fused BiCGStab runners of sharded operators.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import BlockPartition
from ..options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from ..problems.stencil import Stencil, _strides, linear_offset


class StencilOperator:
    """y = A @ x for an N-D stencil over a row-major-linearized grid."""

    def __init__(
        self,
        shape: Sequence[int],
        offsets: Stencil,
        partition: Optional[BlockPartition] = None,
        mesh=None,
        options: SolverOptions = DEFAULT_OPTIONS,
        use_pallas: bool = True,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded operators are not ported to the torch package yet"
            )
        self.shape = tuple(int(d) for d in shape)
        self.offsets = [(tuple(int(c) for c in o), float(v)) for o, v in offsets]
        self.n = int(np.prod(self.shape))
        self.mesh = None
        self.options = options
        self.device = resolve_device(device)
        self.partition = partition or BlockPartition(self.n, 1)
        self.strides = _strides(self.shape)
        self.lin_offsets = [linear_offset(self.shape, o) for o, _ in self.offsets]
        self.band_lo = max(0, -min(self.lin_offsets, default=0))
        self.band_hi = max(0, max(self.lin_offsets, default=0))
        self._view = self._plan_pallas_view() if use_pallas else None
        self._diag_cache = {}

    @property
    def uses_pallas(self) -> bool:
        """Whether the kernel view is active (name kept from the JAX
        package, where the kernels are Pallas)."""
        return self._view is not None

    @property
    def supports_matvec_dot(self) -> bool:
        return self.partition.num_pieces == 1

    # ======================================================================
    # kernel view
    # ======================================================================
    def _plan_pallas_view(self):
        """The grid view the kernels run on, or None.  Requires one
        unpadded piece, f32 and a stencil within the kernels' gate: K3/K4
        for 2-D grids, K6 for 3-D ones."""
        from ..ops.cuda.stencil2d import supports
        from ..ops.cuda.stencil3d import supports3d

        if self.partition.num_pieces != 1 or self.partition.padded_size != self.n:
            return None
        if self.options.entry_dtype != torch.float32:
            return None  # fp64 goldens take the linearized path, as in JAX
        vals = tuple(v for _, v in self.offsets)
        if len(self.shape) == 2:
            Br, C = self.shape
            offs = tuple((o[0], o[1]) for o, _ in self.offsets)
            if supports(Br, C, offs):
                return {"kind": "2d", "C": C, "Br": Br, "offs": offs,
                        "vals": vals}
        elif len(self.shape) == 3:
            X, Y, Z = self.shape
            offs3 = tuple(o for o, _ in self.offsets)
            if supports3d(X, Y, Z, offs3):
                return {"kind": "3d", "Y": Y, "Z": Z, "Br": X,
                        "offs3": offs3, "vals": vals}
        return None  # the 1-D flat view is not ported

    def _kw(self):
        v = self._view
        offs = v["offs3"] if v["kind"] == "3d" else v["offs"]
        return dict(offsets=offs, values=v["vals"])

    def _grid(self, a: torch.Tensor) -> torch.Tensor:
        v = self._view
        if v["kind"] == "3d":
            return a.reshape(v["Br"], v["Y"], v["Z"])
        return a.reshape(v["Br"], v["C"])

    def _exchange_planes3d(self, g: torch.Tensor):
        """([Y, Z] top, [Y, Z] bot) x-halo planes of the local [X, Y, Z]
        block.  On one device the volume's neighbours are the grid's
        boundary, so both are zero planes, passed as ``None``; the sharded
        exchange comes with the multi-device port."""
        return None, None

    def _pallas_local_3d(self, x: torch.Tensor, *, with_dot: bool = False):
        from ..ops.cuda.stencil3d import grid3d_stencil_matvec

        g = self._grid(x)
        top, bot = self._exchange_planes3d(g)
        out = grid3d_stencil_matvec(g, top, bot, with_dot=with_dot,
                                    **self._kw())
        if with_dot:
            y, dot = out
            return y.reshape(x.shape), dot
        return out.reshape(x.shape)

    def _pallas_local(self, x: torch.Tensor, *, with_dot: bool = False):
        from ..ops.cuda.stencil2d import grid2d_stencil_matvec

        if self._view["kind"] == "3d":
            return self._pallas_local_3d(x, with_dot=with_dot)
        out = grid2d_stencil_matvec(self._grid(x), with_dot=with_dot,
                                    **self._kw())
        if with_dot:
            y, dot = out
            return y.reshape(x.shape), dot
        return out.reshape(x.shape)

    # ======================================================================
    # linearized path: shifted 1-D slices + integer boundary masks
    # ======================================================================
    def _diag_values(self, dtype, device):
        """Per-offset masked diagonal values over the padded index space."""
        key = (dtype, device)
        if key not in self._diag_cache:
            N = self.partition.padded_size
            g = torch.arange(N, device=device)
            dvals = []
            for off, v in self.offsets:
                m = g < self.n
                for d, o in enumerate(off):
                    if o:
                        p_d = (g // self.strides[d]) % self.shape[d]
                        m = m & (p_d + o >= 0) & (p_d + o < self.shape[d])
                dvals.append(m.to(dtype) * torch.tensor(v, dtype=dtype))
            self._diag_cache[key] = dvals
        return self._diag_cache[key]

    def _linear_local(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x over the flat padded vector."""
        N = self.partition.padded_size
        lo = self.band_lo
        x_ext = F.pad(x, (lo, self.band_hi))
        y = torch.zeros_like(x)
        for dval, doff in zip(self._diag_values(x.dtype, x.device),
                              self.lin_offsets):
            y = y + dval * x_ext[lo + doff: lo + doff + N]
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  ``x`` may be flat or (with the kernel view) the grid
        layout; the result matches the input layout."""
        if self._view is not None:
            return self._pallas_local(x)
        if x.dim() > 1:
            raise ValueError("grid-layout input requires the kernel view")
        return self._linear_local(x)

    def matvec_dot(self, x: torch.Tensor):
        """(A @ x, <x, A x>), the reduction fused into the kernel pass on
        the kernel view."""
        if self.partition.num_pieces > 1:
            raise ValueError("fused-dot input needs a single piece")
        if self._view is not None:
            return self._pallas_local(x, with_dot=True)
        y = self.matvec(x)
        return y, torch.sum(x * y)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    # ======================================================================
    # fused CG runners
    # ======================================================================
    @property
    def supports_fused_cg(self) -> bool:
        """A fused runner exists for every single-piece operator: the
        kernel schedules on the view, the torch recompute runner otherwise."""
        return self.partition.num_pieces == 1

    @property
    def step2_eligible(self) -> bool:
        """Whether the s-step schedule (two iterations per K1 pass) applies:
        2-D kernel view, stencil reach 1, not disabled by
        LEGIONSOLVERS_NO_SSTEP."""
        from ..ops.cuda.stencil2d import step2_supported

        if os.environ.get("LEGIONSOLVERS_NO_SSTEP"):
            return False
        v = self._view
        if v is None or v["kind"] == "3d":
            return False
        return step2_supported(v["Br"], v["C"], v["offs"])

    def _make_step2_cg_runner(self, num_iterations: int):
        """s-step fused CG: one K1 pass per TWO iterations, both
        iterations' coefficients derived (cg2_coeffs) from the Gram matrix
        of {r, Ar, p, Ap, A^2p} that the previous pass emitted.  A K2 pass
        bootstraps the recurrence from any (x, r, p, rr) state; an odd
        trailing iteration runs as a K3 ``update`` plus a torch xpay.

        ``run(x, r, p, rr0) -> (x, r, p, history)``: x is updated in place
        and r, p alternate with one ping-pong pair of buffers, so the
        inputs must not share storage with anything the caller keeps.
        History entries after odd iterations are the Gram-derived rr1,
        after even iterations the next Gram's <r, r>.

        Every LEGIONSOLVERS_SSTEP_REFRESH passes (default 16; 0 disables)
        the Gram is re-measured by a K2 pass, bounding the drift of the
        monomial basis."""
        from ..ops.cuda.stencil2d import (
            cg2_coeffs,
            grid2d_cg_gram2,
            grid2d_cg_step2,
            grid2d_cg_update,
        )

        kw = self._kw()
        K, odd = divmod(num_iterations, 2)
        refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = self._grid(x), self._grid(r), self._grid(p)
            hist = [torch.as_tensor(rr0, dtype=torch.float32,
                                    device=x.device)]
            spare = (torch.empty_like(r), torch.empty_like(p))

            def passes(g, r, p, spare, count):
                for _ in range(count):
                    coef, rr1, _ = cg2_coeffs(g)
                    _, rn, pn, g = grid2d_cg_step2(x, r, p, coef, out=spare,
                                                   **kw)
                    spare, r, p = (r, p), rn, pn
                    hist.extend((rr1, g[0]))
                return g, r, p, spare

            g = grid2d_cg_gram2(r, p, **kw)
            if refresh > 0 and K > refresh:
                n_blocks, rem = divmod(K, refresh)
                g, r, p, spare = passes(g, r, p, spare, refresh)
                for _ in range(n_blocks - 1):
                    g = grid2d_cg_gram2(r, p, **kw)
                    g, r, p, spare = passes(g, r, p, spare, refresh)
                if rem:
                    g = grid2d_cg_gram2(r, p, **kw)
                    g, r, p, spare = passes(g, r, p, spare, rem)
            else:
                g, r, p, spare = passes(g, r, p, spare, K)
            if odd:
                alpha = g[0] / g[1]
                _, r, rr_new = grid2d_cg_update(p, x, r, alpha, **kw)
                hist.append(rr_new)
                p = r + (rr_new / g[0]).to(p.dtype) * p
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    def make_fused_cg_runner(self, num_iterations: int):
        """A whole-loop CG runner, ``run(x, r, p, rr0) -> (x, r, p,
        history)`` with history[0] = rr0; inputs flat or grid layout, and
        consumed (updated in place).  On the 2-D kernel view it is the
        s-step schedule where :attr:`step2_eligible`, otherwise two passes
        per iteration:

        * K4 ``xpay_pq``: p = r + beta p and <p, A p> (A p never stored);
        * K3 ``update``: x += alpha p, r -= alpha A p, <r, r>.

        Iteration 0 uses the incoming p (a K3 ``pq`` pass instead of
        ``xpay_pq``), so the loop continues standard CG exactly from any
        (x, r, p, rr) state.  The 3-D view runs the same schedule on K6
        (:meth:`_make_pallas3d_cg_runner`)."""
        if num_iterations < 1:
            raise ValueError("fused CG runner needs at least one iteration")
        if self._view is None:
            return self._make_jnp_cg_runner(num_iterations)
        if self._view["kind"] == "3d":
            return self._make_pallas3d_cg_runner(num_iterations)
        if num_iterations >= 2 and self.step2_eligible:
            return self._make_step2_cg_runner(num_iterations)

        from ..ops.cuda.stencil2d import (
            grid2d_cg_pq,
            grid2d_cg_update,
            grid2d_cg_xpay_pq,
        )

        return self._two_pass_cg_runner(num_iterations, grid2d_cg_pq,
                                        grid2d_cg_update, grid2d_cg_xpay_pq)

    def _make_pallas3d_cg_runner(self, num_iterations: int):
        """Fused CG over the 3-D kernels: a K6a ``pq`` + ``update``
        prologue on the incoming p, then per iteration K6b ``xpay_pq`` (p =
        r + beta p formed while loading, 12 B/elt) + K6a ``update`` (20
        B/elt), 32 B/unknown.  On one device p's halo planes are zero
        (``None``).  Same contract as the 2-D runners."""
        from ..ops.cuda.stencil3d import (
            grid3d_cg_pq,
            grid3d_cg_update,
            grid3d_cg_xpay_pq,
        )

        return self._two_pass_cg_runner(num_iterations, grid3d_cg_pq,
                                        grid3d_cg_update, grid3d_cg_xpay_pq)

    def _two_pass_cg_runner(self, num_iterations, cg_pq, cg_update,
                            cg_xpay_pq):
        """The two-pass schedule on the given pass wrappers (2-D or 3-D,
        which take the same arguments).  x and r are updated in place; p
        alternates with one spare, because ``xpay_pq`` cannot write p over
        the p_old that neighbouring blocks read."""
        kw = self._kw()

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = self._grid(x), self._grid(r), self._grid(p)
            rr = torch.as_tensor(rr0, dtype=torch.float32, device=x.device)
            hist = [rr]
            pq = cg_pq(p, **kw)
            _, r, rr_new = cg_update(p, x, r, rr / pq, **kw)
            hist.append(rr_new)
            spare = torch.empty_like(p)
            for _ in range(1, num_iterations):
                rr_prev, rr = rr, rr_new
                pn, pq = cg_xpay_pq(r, p, rr / rr_prev, out=spare, **kw)
                spare, p = p, pn
                _, r, rr_new = cg_update(p, x, r, rr / pq, **kw)
                hist.append(rr_new)
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    def _make_jnp_cg_runner(self, num_iterations: int):
        """Whole-loop CG for operators without the kernel view (fp64
        goldens, 1-D grids, stencils beyond the kernels' reach): the
        classic schedule with the linearized matvec, in the arithmetic
        order of ``CGSolver.step``
        (reference: CGSolver.hpp:46-55).  Name kept from the JAX package."""

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = (a.reshape(-1) for a in (x, r, p))
            rr = torch.as_tensor(rr0, dtype=x.dtype, device=x.device)
            hist = [rr]
            for _ in range(num_iterations):
                q = self._linear_local(p)
                alpha = rr / torch.sum(p * q)
                x = x + alpha * p
                r = r - alpha * q
                rr_new = torch.sum(r * r)
                hist.append(rr_new)
                p = r + (rr_new / rr) * p
                rr = rr_new
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    # ======================================================================
    # fused BiCGStab runner
    # ======================================================================
    @property
    def supports_fused_bicgstab(self) -> bool:
        """Whether :meth:`make_fused_bicgstab_runner` is available: the
        kernel view within the K5 (2-D) or K7 (3-D) gate, not disabled by
        LEGIONSOLVERS_NO_FUSED_BICGSTAB.  Sharded operators have fused
        runners in the JAX package; they come with the multi-device
        slice."""
        from ..ops.cuda.bicgstab2d import bicgstab_supported
        from ..ops.cuda.bicgstab3d import supports3d_bicgstab

        if os.environ.get("LEGIONSOLVERS_NO_FUSED_BICGSTAB"):
            return False
        v = self._view
        if v is None:
            return False
        if v["kind"] == "3d":
            return supports3d_bicgstab(v["Br"], v["Y"], v["Z"], v["offs3"])
        return bicgstab_supported(v["Br"], v["C"], v["offs"])

    def make_fused_bicgstab_runner(self, num_iterations: int):
        """Whole-loop BiCGStab on the three K5 passes (K7 on the 3-D view:
        :meth:`_make_bicgstab3d_runner`; 60 B/unknown per iteration at
        f32), or None where :attr:`supports_fused_bicgstab` is False.
        Contract: ``run(x, r, p, v, rt, rho, alpha, omega) -> (x, r, p, v,
        rho, alpha, omega, history)`` with history[0] = <r, r>
        on entry; an exact continuation of the transcription recurrence
        (reference: BiCGStabSolver.hpp:64-82) from any state.  Inputs are
        flat or grid layout; outputs take the input layout.

        Per iteration: ``pv`` gives p', v' = A p' and <r~, v'> (alpha);
        ``st`` gives <t, s> and <t, t> (omega); ``update`` gives x', r',
        <r', r'> (history) and <r~, r'> (the next rho).  About six scalar
        ops on 0-dim device tensors join them; nothing is read back.

        Buffers: x is updated in place.  p, v and r alternate with
        ping-pong spares, because a pass writing p, v or r in place would
        race a neighbouring block's halo read.  So the runner holds eight
        live grid vectors (x, r, r', p, p', v', v, r~: 537 MB at 4096^2,
        537 MB at 256^3) where the JAX runner holds five; it writes into
        the x, r, p and v it is given (which must share no storage with r~
        or each other) and never into r~."""
        if not self.supports_fused_bicgstab:
            return None
        if self._view["kind"] == "3d":
            return self._make_bicgstab3d_runner(num_iterations)
        from ..ops.cuda.bicgstab2d import bicg_pv, bicg_st, bicg_update

        return self._bicgstab_runner(num_iterations, bicg_pv, bicg_st,
                                     bicg_update)

    def _make_bicgstab3d_runner(self, num_iterations: int):
        """The fused BiCGStab loop on the three K7 passes; single device,
        so the combined operands' halo planes are zero (``None``)."""
        from ..ops.cuda.bicgstab3d import bicg3d_pv, bicg3d_st, bicg3d_update

        return self._bicgstab_runner(num_iterations, bicg3d_pv, bicg3d_st,
                                     bicg3d_update)

    def _bicgstab_runner(self, num_iterations, pv, st, update):
        """The loop of :meth:`make_fused_bicgstab_runner` on the given pass
        wrappers (2-D or 3-D, which take the same arguments)."""
        from ..ops.cuda.bicgstab2d import _pdot

        kw = dict(self._kw(), compensated=bool(self.options.compensated_dots))
        dot = lambda a, b: _pdot(a, b, kw["compensated"])

        def run(x, r, p, v, rt, rho, alpha, omega):
            shape = x.shape
            x, r, p, v, rt = (self._grid(a) for a in (x, r, p, v, rt))
            rho, alpha, omega = (
                torch.as_tensor(a).to(device=x.device, dtype=torch.float32)
                for a in (rho, alpha, omega))
            hist = [dot(r, r)]
            rtr = dot(rt, r)
            spare_r, spare_p, spare_v = (torch.empty_like(a)
                                         for a in (r, p, v))
            for _ in range(num_iterations):
                rho_new = rtr
                beta = (rho_new / rho) * (alpha / omega)
                pn, vn, rtv = pv(r, p, v, rt, beta, omega,
                                 out=(spare_p, spare_v), **kw)
                spare_p, spare_v, p, v = p, v, pn, vn
                alpha = rho_new / rtv
                ts, tt = st(r, v, alpha, **kw)
                omega = ts / tt
                _, rn, rr, rtr = update(r, v, x, p, rt, alpha, omega,
                                        out=spare_r, **kw)
                spare_r, r = r, rn
                hist.append(rr)
                rho = rho_new
            x, r, p, v = (a.reshape(shape) for a in (x, r, p, v))
            return x, r, p, v, rho, alpha, omega, torch.stack(hist)

        return run

    def transpose(self) -> "StencilOperator":
        """A^T: offset o with value v becomes offset -o.  Cached."""
        if not hasattr(self, "_transpose_op"):
            self._transpose_op = StencilOperator(
                self.shape,
                [(tuple(-c for c in o), v) for o, v in self.offsets],
                partition=self.partition,
                options=self.options,
                use_pallas=self._view is not None,
                device=self.device,
            )
        return self._transpose_op

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T @ x."""
        return self.transpose().matvec(x)
