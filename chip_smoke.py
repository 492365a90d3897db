#!/usr/bin/env python3
"""Smoke run of the PyTorch port's solver and benchmark paths on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--profile]

Two other modes compare trees of the package on one card instead:
``--solves [--tree DIR]`` prints, for the package of DIR (default this
one), 2-D CG's distance from float64 at three sizes, the ms/iter and host
enqueue ms/iter of the 2-D CG (s-step and two-pass), 2-D PCG(Jacobi), 2-D
BiCGStab (f32 and compensated dots), random-2^20 CG and 3-D CG and
BiCGStab (7- and 27-point at 256^3) solve(200)s, five runs each, the
host's enqueue time of one K10 call, the times of K3 (four modes), K4, K5b
(compensated dots off and on) and K2 at 4096^2 and of K6b and K7 st and
update (compensated dots off and on) at 256^3, and K12 and ``torch.add``
in turns (one JSON line); ``--ab PARENT`` runs ``--solves`` on PARENT and
on this tree, alternating parent, change, change, parent, and prints the
medians and ranges.  ``--breakdown [--dim 2|3|4] [--size N] [--tree
DIR]`` runs phase 4d's f32 BiCGStab on the 7-point system at 256^3 (dim 3,
the default), on the 27-point one (dim 4), or phase 4b's on the 5-point
system at 4096^2 (dim 2; N^2 with ``--size``) from several right-hand
sides (:func:`breakdown`).
``--band-accuracy [--tree DIR]`` runs the two-pass CG of 4n's S2_gen and
S2_4x systems from several right-hand sides, with the kernels and driven
by the plain versions, against float64 CG (:func:`band_accuracy`).
``--bicg-gap [--tree DIR]`` reads the fused BiCGStab's recurrence gap on
S2_4x and S2_gen from several right-hand sides, with K5a, K5b and K5c on
either kernel (:func:`bicg_gap_draws`).
``--passes [--tree DIR]`` prints the times of K3, K4, K5b, K2 and K1 at
4096^2 that ``--solves`` takes (:func:`time_ab_passes_2d`), and K3's four
modes, K4, K5a, K5b and K5c with the band route's stencils (S2_4x, S2_gen
and 4l's wide_kw at 4096^2: the band route of this tree, the tile kernels
of a tree from before it), K5a-c with the cross and the 1-D view's
Laplacian (K5b there also compensated and on the band march), K2 on its
route with S2_gen, S2_4x and S2_far and on its cooperative kernel, and
the host's enqueue of one K5b call, and nothing else.  ``--blocks`` runs
phases 4i and 5i (block systems) and nothing else, ``--pieces`` phases 4j
and 5j (pieces on one card), ``--explicit-pieces`` phases 4k and 5k
(explicit matrices on pieces; it builds the one-piece DIA and scrambled
systems of 4e-f too, to compare),
``--flat1d`` phases 4l and 5l (the 1-D kernel view at 2^24 unknowns),
``--wide3d`` phases 4m and 5m (wide z shifts on the 3-D kernels at 256^3)
and K1's nop mode (its check and its time), ``--wide2d`` phases 4n and 5n
(K1 and K2 on their general route and K3, K4 and K5a-c on the band
route, 2-D stencils with wide column shifts, at 4096^2), ``--utils``
phase 4o (the host library, Matrix Market files and checkpoints),
``--processes`` phase 4p (the main path over two processes; it starts two
workers of this script, ``--worker RANK PORT DIR``).
``--builds`` prints the host seconds of phase 4e-g's three builds and 4k's
four and the chains and geometries they pick (run it also under
LEGIONSOLVERS_NO_NATIVE=1 for the numpy versions' seconds).

Phases (any failure raises, and the exit code is non-zero):

1. the card: ``nvidia-smi`` name and power limit; no CUDA -> exit 2;
2. build the hand-written kernels of ``legionsolvers_tpu_torch/csrc`` (one
   nvcc per source, all started together);
3. hold every kernel against its plain PyTorch version on the card, at the
   main-path shape 4096 x 4096 and a ragged 200 x 328: elementwise outputs
   to atol 1e-5 * max|ref|, dots and Gram entries to rtol 1e-4 of the
   entry's Cauchy-Schwarz scale sqrt(<a,a><b,b>) (the f32 sums run in
   another order; the scale is the entry itself for squared norms).  The
   BiCGStab passes (K5) run with compensated dots off and on; compensated
   dots are also held within 4e-7 relative of the float64 sum of their f32
   operands.  K1 (step2) also runs at 33 x 4097, 4099 x 130 and 1 x 5 (the
   edges of its 120-column strips, its row chunks and its 16-byte
   vectors), with the cross and a 9-point reach-1 stencil, to the same
   bounds, and a repeat on the same inputs must match bit for bit.  K5b
   (bicg_st, compensated dots off and on) and K2 (gram2), the passes on
   K1's column-strip march, at 200 x 328, 33 x 4097, 4099 x 130, 1 x 5
   and 96 x 132 with the cross and the 9-point stencil (and K5b with a
   reach-2 cross, which runs the band route), to the same bounds and bit
   for bit on a repeat, and so K3 (four modes) and K4 (reach 2: the band
   route); a torch.profiler trace shows that the strip passes and the band
   route (K5c with the reach-2 cross too) launch one kernel and no
   reduce_partials, and that reach-1 K5a, on its tile kernel, launches its
   second.  The strip
   kernels' registers, spill bytes and resident blocks per SM are printed
   after the build;
4. drive the CG path, ``entry.build_system(4096)`` -> ``CGSolver``: a
   few eager ``step()``s (K3 y_dot), ``solve(200)`` (K1 x100, K2 x7),
   ``solve(201)`` (adds one K3 update), a two-pass ``solve(200)`` under
   LEGIONSOLVERS_NO_SSTEP (K3 pq x1, update x200, K4 x199) and a residual
   check through ``planner.matvec`` (K3 y), with the launch counters
   checked exactly; the two-pass solve again from the same state
   (bit-identical history and x, the same launches), its history and x
   held to float64 CG like the s-step solve's, and ||b - Ax||^2 to its
   last history entry within twice textbook f32 CG's gap, or 1e-3;
   then hold the solve against the same schedule driven by the plain
   versions on the card (rtol 1e-3 while textbook f32 CG stays within
   5e-4 of float64 CG), against float64 CG over all 200 (no worse than
   twice textbook f32 CG: f32 CG on this system leaves exact arithmetic by
   ~3e-3 within 200 iterations; the same bound on fresh solves at 2048^2
   and 3001^2), and at 256 x 256 against a float64 numpy CG (rtol 1e-3);
4b. drive the BiCGStab path, ``build_system(4096)`` -> ``BiCGStabSolver``:
   eager ``step()``s (K3 y, y_dot), ``solve(200)`` (K5 pv, st, update
   x200 each, counted exactly), the same solve again from the same state
   (bit-identical history and x: a halo race would show here), ``||b -
   Ax||^2`` through ``planner.matvec`` (K3 y) against the last history
   entry (rel 5e-2: a wrong update leaves an O(1) gap, f32 rounding along
   this trajectory ~1e-2).  f32 BiCGStab on this system amplifies a 1e-7
   difference ~1e3-fold per iteration after the second, so two f32 codes
   are held together through two iterations (rtol 1e-6: eager vs fused;
   compensated kernel vs plain-driven), and one iteration continued from
   the kernel path's own state at iterations 0..199 to 1e-2.  Against
   float64 BiCGStab: the kernel path stays within 1e-3 at least as long
   as textbook f32 BiCGStab does, and ends with ||b - Ax||^2 and x error
   no worse than twice textbook f32's, at 4096^2 (f32 dots) and at 256^2
   (compensated dots: with f32 dots that run breaks down when rho sums to
   exactly 0 near the f32 floor);
3c. the 3-D kernels: K6a (y, y_dot, pq, update), K6b (xpay_pq) and K7
   (pv, st, update; compensated dots off and on) against their plain
   versions, 7- and 27-point stencils (every pass on the reach-1
   register march, march1, but K7 update with compensated dots, on
   march3d) and a reach-2 11-point star (every pass on the window march),
   at the main-path shape 256^3 and a ragged 37 x 45 x 130, with random
   halo planes; the bounds of phases 3 and 3b.  A torch.profiler trace of
   one call of each pass shows that the march1 and window-march passes
   launch one kernel of their march (``route3d``) and no second reduction
   launch (reduce_partials), and that the march3d pass launches it.  Each
   march1 and window-march kernel's registers, spill bytes and resident
   blocks per SM (cudaFuncGetAttributes, the occupancy calculator; the
   window kernels' with S_wide at 256^3) are printed after the build;
4c. drive the 3-D CG path, ``entry.build_stencil_system(3 | 4, (256,)*3)``
   -> ``CGSolver``: eager ``step()``s (K6a y_dot), ``solve(200)`` (1 pq +
   200 update + 199 xpay_pq, counted exactly), the same solve again
   (bit-identical), ||b - Ax||^2 through ``planner.matvec`` (K6a y)
   against the last history entry, and the solve against float64 CG
   written here with its own matvec; the bounds (constants below) come
   from textbook f32 CG's own distance from float64 on these systems;
4d. drive the 3-D BiCGStab path on the same systems: 200 launches of each
   K7 pass, a bit-identical repeat, ||b - Ax||^2 after 20 iterations
   against the history, and float64 BiCGStab as phase 4b holds it (f32
   BiCGStab breaks down on the 7-point system, textbook f32 too, so the
   end result is held with compensated dots);
5. time each kernel and the whole solve(200) of both solvers (and the host's
   enqueue time of the solve) against their plain versions with CUDA events, after a warm-up, over a ring of input
   sets so that L2 does not serve repeats, refusing any time that would
   beat the card's measured copy bandwidth; each K3 and K4 row is logged
   with its launches per solve(200) on the two-pass CG, PCG and GMRES
   paths and the ms it loses there, launches x (time - bound).
   ``--profile`` adds a ``torch.profiler`` trace of the 2-D BiCGStab solve
   and of the four 3-D solves, last.  The 3-D kernels and the four 3-D solves
   are timed the same way at 256^3, each 3-D kernel logged with its launches
   per solve(200) and the ms it loses there, launches x (time - bound), and
   K7 pv with compensated dots off, on, on, off (7-, 27-point, reach 2);
   ``F.conv2d`` and ``F.conv3d`` computing K3's and K6a's y are timed as the
   library yardstick.  Each kernel's bound is the larger of its minimum bytes
   over the measured copy bandwidth and its f32 operations over the card's
   f32 peak.

4i. block systems (``parallel/block_fused.py``): ``entry.
   build_stencil_system(..., num_spaces=2)``, the same operator on two
   spaces, -> s-step CG, two-pass CG (LEGIONSOLVERS_NO_SSTEP) and BiCGStab
   at 4096^2 and CG and BiCGStab on the 7-point system at 256^3, each
   solve(200) beside the single-space solve(200) of the same system.
   Identical spaces (b = 1): launches exactly twice one space's (K1 2 x
   100 and K2 2 x 7, K5 2 x 200 each, ...), one ``cg2_coeffs`` per pass
   and not per space, no plain version called (every ``*_plain`` of the
   kernel modules counts its calls), the history exactly twice one
   space's and every space's x bit for bit one space's, and a repeat bit
   for bit.  Distinct spaces (b1 = 1 + 0.01 z) at 4096^2: CG's history
   and x no further from float64 block CG than twice textbook f32 block
   CG (phase 4's rule); BiCGStab's eager step()s against the solve (rtol
   1e-6 over the first N_AGREE entries) and ||b - Ax||^2 over both spaces
   against its last history entry (5e-2), as phase 4b;

The explicit-sparse path (the planner's upgrades of explicit matrices):

4e-g. build three systems through ``entry.build_explicit_system`` (host
   seconds printed; the operator chain and plan geometry asserted): the
   2-D 5-point Laplacian at 4096^2 (``DiaOperator``, K8), the same
   Laplacian at 2048^2 with rows and columns scrambled by
   ``default_rng(0).permutation`` (an RCM basis, ``WinEllOperator``, K9)
   and a random SPD matrix at n = 2^20 (4 entries per row symmetrized, plus
   16 on the diagonal; the routed gather in its degree-sorted basis, K10,
   six hops per matvec);
3e. K8 (with and without the dot) at 4096^2 with D = 5 and at a ragged
   200 x 328 with random coefficients and halos, K9 on the scrambled
   system's plan, one ``SlicedWinEllOperator`` matvec on a graded band (n =
   2^20, bandwidth 512, degrees 3..27), and K10 on the six hop geometries
   of the 2^20 plan in f32 and f64, each against its plain version: the
   kernels round every product and sum as the plain versions do, so the
   outputs must match bit for bit (K8's dot: phase 3's bound); and K10 at
   the interface's caps (block_rows 256, src_block_rows 64, w_rows 8) with
   runs of 256 rows (the window staged in shared memory) and of one row
   (gathered from global memory), f32 and f64, bit for bit;
   then each system's CG path: eager ``step()``s, ``solve(200)`` with K8
   (dot), K9 and K10 launches counted exactly, a bit-identical repeat,
   ||b - Ax||^2 through ``planner.matvec`` against the history, and the
   history and x against float64 CG (the float64 ``lap5`` CG at 4096^2 and
   2048^2 - b = 1 is unchanged by the scrambling - and a scipy CSR CG for
   the random system), held to twice textbook f32's own distance; and
   ``BiCGStabSolver.solve(200)`` on the random system, inside its basis,
   against float64 BiCGStab the same way.  On the random system f32 CG's
   recurrence sinks into f32's denormals and f32 BiCGStab's reaches 0 and
   then divides 0 by 0 (near iteration 18), as the reference and textbook
   f32 do; those checks hold the finite entries, and ||b - Ax||^2 after a
   few iterations;
5g. time K8, K9, K10 and the three CG solves with CUDA events, against the
   plain versions; the library yardsticks are one ``torch.sparse`` CSR
   SpMV (cuSPARSE) of the same matrix in the operator's basis (K8, K9 and
   the whole routed matvec) and ``torch.take`` on each hop's precomputed
   flat index (K10, its scale excluded).  K10's hops and ``torch.take`` are
   also timed in CUDA graphs (device time alone: the small hops take less
   time on the card than their enqueue on the host; ``graph_ms`` and
   ``library_graph_ms`` in the kernels line).  ``--profile`` adds traces of
   the three explicit CG solves.

The benchmark CLI path (``legionsolvers_tpu_torch.benchmark``, GMRES, PCG
and the roofline probes):

3h. K11 (``chain_probe``: fma, roll, row at reps 1, 2 and 16) on the
   probe's [256, 1024] tile: roll and row bit for bit, fma within
   ``fma_rtol`` (one rounding per step where the plain version rounds
   twice); K12 (``copy_probe``) bit for bit at 16384 x 4096, 200 x 328
   and n = 1000003 (n % 4 != 0: the scalar rest), and on an offset view
   (unaligned: the scalar kernel alone);
4h. ``benchmark.main`` at full width with the triad bandwidth measured once
   and passed as ``bw``: ``-dim 2`` at 4096^2 with CG, BiCGStab and PCG at
   ``-it 200`` and GMRES(10) at ``-it 20``, ``-dim 3`` at 256^3 with GMRES
   and PCG; each run's launches are counted exactly from the solves it ran
   (``benchmark.RUNS``): K1 one per two CG iterations plus the compute
   ceiling's, K2 per Gram refresh, K5 per BiCGStab iteration, K3/K6a
   ``y_dot`` per PCG iteration and ``y`` per GMRES matvec; the CG run
   measures the op rates with K11; no roofline share above 100%.  Then
   ``probe_roofline.main`` (the triads and K12).  Checks: PCG(Jacobi) at
   4096^2 against float64 CG no worse than twice textbook f32 CG (the
   diagonal is constant, so PCG is CG in exact arithmetic); f32 GMRES(10)
   at 4096^2 non-increasing within GMRES_SLACK and ||b - Ax||^2 through
   ``planner.matvec`` within 1e-3 of its last entry; f64 GMRES and PCG at
   256^2 on the card against the CPU (rtol 1e-8);
5h. K12 against ``torch.add(x, 1.0, out=y)`` in turns (K12, add, add,
   K12; medians and ranges of 12 such rings) and K11 at 256 trips with
   CUDA events (roll's and row's bound: their steps at the shared-memory
   rate, 128 B per SM per clock at ``clocks.max.sm``, over 8 B per step),
   K11's three rates from the marginal time of its long and short chains, the triads, the measured K1 compute ceiling (resident
   only if its apparent rate is over 1.5x the stream's) and each CLI run's
   ms/iter, Gnnz/s and binding roofline; K1's nop mode (step2's loads and
   stores, a trivial body; no solve calls it) beside K1 step2 at 4096^2,
   CUDA events and graphs: K1's memory floor with step2's access pattern.  Every bound uses the faster of
   ``copy_`` and K12.  ``--profile`` adds the idle share of each CLI run's
   solve.

5i. the five block solve(200)s of phase 4i and their single-space
   solves: ms/iter with CUDA events and host enqueue ms/iter
   (:func:`solve_ms`), and each block solve's idle share, 1 - its device
   time (a torch.profiler trace, taken after the timings) over its wall.

Pieces on one card (``parallel/mesh.py``, ``overlap.py``,
``sstep_sharded.py``; ``make_mesh(S, devices=[card] * S)``):

4j. the 2-D system at 4096^2 through ``entry.build_system(..., mesh=)``:
   the matvec on 4 and 8 pieces against one piece (4 eps max|x| sum|v|);
   the s-step solve(200) on 4 pieces (K1 400, K2 28) and 8 (K1 800, K2
   56) and the two-pass one on 4 (K3 pq 4, K4 796, K3 update 800), each
   with ``cg2_coeffs`` as often as on one piece (100), no plain version
   called, history and x within twice textbook f32 CG's distance from
   float64 CG, a repeat bit for bit and its distance from the one-piece
   solve; then the matvec and each solve again with every K1-K4 call held
   to its plain version on copies of the same inputs (phase 3's bounds,
   :class:`shadowed`), and each solve driven by the plain versions (its
   twin: no kernel launched; its distance from float64, one piece's
   twin's and the kernels' solve's distance from it reported); the
   CLI's ``-dim 2 -solver 1 -vp 4`` (PIECE_CLI_ITERS, a fifth of
   N_ITERS: host-bound, and its checks do not turn on the length);
5j. those solves' ms/iter and host enqueue ms/iter beside one piece's in
   the same process, the torch glue operations per pass counted on the
   host, the host enqueue of one K1, K4 and K3 update wrapper call (on a
   piece and on the whole grid) and the host µs per glue operation they
   imply, and (after every other timing) each one's idle share from a
   profiler trace.  ``--pieces`` runs 4j and 5j alone (~2 min with the
   build).

Explicit matrices on pieces of the card (``parallel/distmatrix.py``'s halo
exchange and K9 per piece, ``parallel/dia_op.py``'s zero-halo K8 per piece
with its edge fix-ups; ``entry.build_explicit_system(..., mesh=make_mesh(4,
devices=[card] * 4))``):

4k. (i) test_05's float64 golden, COO and CSR at n = 100 on 4 pieces,
   through the DIA upgrade and the sharded ELL (``prefer_dia=False``),
   exactly; (ii) the 2-D 5-point Laplacian at 4096^2 as COO, a
   ``DiaOperator`` on pieces (C 4096, Br 1024, D 5): CG solve(200) with
   K8 (dot) exactly 4 x 200 launches, then PCG(Jacobi) on the same
   system, the same count; (iii) the same matrix with ``prefer_dia=False``,
   the sharded ``RowPartitionedMatrix`` with its windowed plan (``_win``:
   KR 40, L 5, Rt 8), K9 exactly 4 x 200; (iv) the scrambled 2048^2
   system, an RCM basis over the sharded ELL with its windowed plan (KR
   24; what JAX picks on a 4-device mesh), K9 4 x 200; (v) the random SPD
   system at n = 2^20, the sharded gather-ELL (no windowed plan, no
   kernel), its finite entries and ||b - Ax||^2 after 4 iterations.  Each
   build's host seconds and operator chain; for (ii)-(iv) no plain
   version called, a repeat bit for bit, every K8 / K9 call held to its
   plain version on copies of its inputs (:class:`shadowed_sparse`, phase
   3's bounds), history and x within twice textbook f32 CG's distance
   from float64 CG, and the distance from the one-piece solve of 4e-g;
5k. those solves' ms/iter and host enqueue ms/iter beside the one-piece
   solve of the same matrix in the same process, the torch glue
   operations per iteration counted on the host, and each one's idle
   share from a profiler trace taken after the timings.

The 1-D kernel view (``-dim 1``: ``parallel/stencil_op.py`` views a 1-D
grid as ``[n // C, C]`` and the kernels run its row-wrap terms, |dx| = C -
1, as the 1-D stencil over the flat index, ``stencil2d.route``):

4l. every route against its plain version on the decomposed offsets, at
   full width ([4096, 4096], random halo blocks) and at (8, 128), (37,
   1000), (3, 1000) and (203, 4096) with null and random halo blocks: K3's
   four modes and K4 on the strip march with WRAP, K2, K1 and K5b on the
   march along the flat index (``csrc/flat1d.cu``), K5a and K5c on the
   band route (``csrc/band2d.cu``; K5 with compensated dots off and on),
   and the
   wide terms of K3, K4 and K5a-c (the band route) with (0, +-37), (1,
   -(C - 1)) and (-8, 100); phase
   3's bounds and repeats bit for bit.  Then
   ``entry.build_stencil_system(1, (2^24,))`` on one piece and on 4 pieces
   (Br 1024): s-step CG (K1 100, K2 7), two-pass CG (K3 pq 1, update 200,
   K4 199), fused BiCGStab (K5a-c 200 each), PCG (K3 y_dot 200) and
   GMRES(10) x 20 (K3 y 221) on one piece, two-pass CG and the fused
   BiCGStab on 4 pieces (four times those), each solve's launches counted
   exactly, no plain version called, the operator on the flat view, a
   repeat bit for bit; the CG histories and x within twice textbook f32
   CG's distance from float64 CG on the 1-D system (the s-step's with
   phase 4c's floor, X_F64_FLOOR: ROADMAP queue 3, P8; also at
   FLAT_ACC_SIZES, beside the bound and the plain versions' readings),
   BiCGStab within
   FLAT_BICG_RTOL of float64 BiCGStab over the entries where textbook f32
   stays within a tenth of it, GMRES non-increasing;
5l. each route's time at [4096, 4096] with CUDA events and in CUDA graphs
   beside its plain version and bound (K5b also on the band march); K1's,
   K2's and K5b's flat kernels' registers, spill, blocks per SM and shared
   memory and their ms lost per s-step or BiCGStab solve(200); the wide
   terms (K3, K4 and K5a-c on the band
   route) at 4096^2 beside the same bound and their ms lost per two-pass
   CG or BiCGStab solve(200);
   and each 4l solve's ms/iter, host enqueue and idle share (a
   torch.profiler trace).  ``--flat1d`` runs 4l and 5l alone.

Wide z shifts on the 3-D kernels (kernel item C: S_wide, the 7-point
cross with center 8.5 plus (0, 0, +-12), (0, +-3, +-100) and (+-1, 0,
+-128); every 3-D pass runs the window march, whose window holds every
z shift a term reads), and K1's nop mode (item D):

4m. K6a's four modes, K6b and K7 (compensated dots off and on) with S_wide
   against their plain versions at 256^3 and at (37, 45, 130), (1, 5,
   301), (20, 7, 129) (|oz| = Z - 1) and (17, 9, 256), random halo planes,
   phase 3c's bounds, repeats bit for bit; K1 nop against its plain
   version at 4096^2, 200 x 328, 33 x 4097 and 1 x 5 (x'', r'', p'' bit
   for bit).  Then ``entry.build_stencil_system(3, (256,)*3,
   stencil=S_wide)``: two-pass CG (K6a pq 1, update 200, K6b 199), the
   fused BiCGStab with f32 and compensated dots (K7 200 each), PCG (K6a
   y_dot 200) and GMRES(10) x 3 (K6a y 34) on one piece, CG (four times
   one piece's) and BiCGStab step() (K6a y and y_dot 4 x 20) on 4 pieces,
   each with its launches counted exactly, no plain version called, the
   operator on the 3-D view and a repeat bit for bit; CG and PCG within
   twice textbook f32 CG's (PCG's) distance from float64 CG over the
   entries where it stays within 1e-3 (f32 CG on S_wide falls past f32's
   accuracy within ~120 iterations), BiCGStab within FLAT_BICG_RTOL of
   float64 BiCGStab where textbook f32 stays within a tenth of it, GMRES
   non-increasing; each window-march kernel's registers, spill bytes,
   shared memory and blocks per SM with S_wide at 256^3 (``[window3d]``);
5m. each wide-z pass at 256^3 with CUDA events and in CUDA graphs beside
   its plain version, its bound, share of the bound and ms lost over 4m's
   launches, ``F.conv3d`` over S_wide's dense (3, 7, 257) box computing
   K6a's y, and each 4m solve's ms/iter, host enqueue and idle share.  ``--wide3d`` runs 4m, 5m and the nop timing alone.

"B (general)", the s-step passes K1 and K2 on their general route
(``csrc/sstep_general.cu``) for 2-D stencils with |dy| <= 1 and any |dx|
< C that are neither reach 1 nor a flat decomposition: S2_gen (the cross
with 7.0 at the centre, (0, +-2), (0, +-37), (+-1, +-100)), S2_4x (-d_xx
to fourth order plus -d_yy to second), S2_far (S2_gen with (+-1, +-200)
for (+-1, +-100)) and S2_past (S2_gen with (+-1, +-1000) for (+-1,
+-100), on 1024 x 5000).  K1 and K2 each run their band march (route
``general``) where their gate takes the stencil, the cooperative kernel
(``general_coop``) where it does not: K1 with S2_far and S2_past, K2
with S2_past:

4n. K1 and K2 against step2_plain and gram2_plain at 4096^2 with S2_gen
   and S2_4x and at 16 x 128 with ``wide(128)``, 4096^2 with (+-1,
   -+4095) (the cooperative K1; K2's window clipped to the row) and with
   S2_far (the cooperative K1), 5 x 130 and 1 x 101 (S2_4x), 33 x 4097
   (S2_gen), 7 x 130 with no (0, 0) term and 37 x 5000 with S2_past (both
   cooperative); phase 3's bounds, repeats bit for bit, each shape on the
   routes its gates give; K2's band march against its cooperative kernel
   on the same inputs in ulps; the band marches' registers, spill bytes,
   shared memory and blocks per SM with S2_gen and S2_4x (K2's also
   S2_far) at 4096 columns (``[band]``).  Then
   ``entry.build_stencil_system(2, (4096, 4096), stencil=...)``: CG
   solve(200) with S2_gen on one piece and on 4 pieces, with S2_4x on one
   piece and as a 2-space block, with S2_far on one piece, each launching
   exactly K1 100 and K2 7 per piece and space, and solve(34) with S2_past
   on one piece of 1024 x 5000 (K1 17, K2 2), nothing of the two-pass
   schedule, no
   plain version called, a repeat bit for bit, every launch of a third
   run held to its plain version (:class:`shadowed`), and history and x
   within twice textbook f32 CG's distance from float64 CG (floor 1e-4;
   the history's margin under it logged).  The band route of K3 (four
   modes) and K4 (``csrc/band2d.cu``): against their plain versions with
   S2_gen, S2_4x and wide_kw at 4096^2 and at BAND_EDGE_SHAPES (C = 128,
   1000 columns under one strip, 3 rows under wide_kw's ring, 130 columns
   on scalar loads, a ragged last band, two strips at 5000 columns, a
   quarter-height piece), null and random halo blocks, and a stencil past
   its gate (a row span of 17) on the tile kernels: phase 3's bounds and
   repeats bit for bit; its registers, spill bytes, shared memory and
   blocks per SM (``[band2d]``); the two-pass CG solve(200) with S2_gen
   on one piece and on 4 pieces and with S2_4x on one piece, each
   launching exactly K3 pq 1, update 200 and K4 199 per piece on the band
   route, PCG (K3 y_dot 200) and GMRES(10) x 3 (K3 y 34) with S2_gen, no
   plain version called, a repeat bit for bit, the CG history and x within
   twice textbook f32 CG's distance from float64 CG (PCG's against
   textbook f32 PCG), GMRES non-increasing, every launch on 4 pieces held
   to its plain version.  K5a, K5b and K5c on the band route (the
   stencil past the gate on their tile kernels) against their plain
   versions at the same shapes,
   compensated dots off and on (compensated dots also within 4e-7 of the
   float64 sum of their operands); the fused BiCGStab solve(200) with
   S2_gen (f32 and compensated dots, and on 4 pieces) and with S2_4x,
   each launching exactly K5a, K5b and K5c 200 per piece, no plain
   version called, a repeat bit for bit, within 1e-3 of float64 BiCGStab
   over the entries where textbook f32 stays within 1e-4 of it and
   ||b - Ax||^2 after 20 iterations within 1e-3 of the history (on b = 1
   + z where b = 1 leaves textbook f32 no such entry: S2_4x), every
   launch on 4 pieces held to its plain version;
5n. K1 on the band march with S2_gen and S2_4x, K1 on the cooperative
   kernel with S2_far, K2 on the band march with S2_gen, S2_4x and S2_far
   at 4096^2, and K2 on the cooperative kernel with S2_past on its grid
   and (forced there) with S2_gen and S2_far at 4096^2, with CUDA events
   and in CUDA graphs beside their plain versions, and the
   S2_gen and S2_4x solves' ms/iter, host enqueue and idle share on the
   s-step schedule and under LEGIONSOLVERS_NO_SSTEP (the two-pass
   schedule, K3 and K4 on the band route); K3's four modes and K4 on the
   band route with S2_gen, S2_4x and wide_kw at 4096^2 the same way, and
   ``F.conv2d`` over S2_4x's 3 x 5 and S2_gen's 3 x 201 box computing K3's
   y; K5a-c on the band route with those stencils beside their tile
   kernels and plain versions, and the BiCGStab solves' ms/iter, host
   enqueue and idle share (S2_gen's also with K5c on its tile kernel).
   ``--wide2d``
   runs 4n and 5n alone;
4o. (a) the host library (``native/csrc/kernels.cpp``, g++) loads, and
   each entry point is held to its numpy version bit for bit with both
   host times: the 2048^2 5-point fill, then on that Laplacian the halo
   columns and ELL packing of its 4 pieces and its DIA offsets and f32
   and f64 coefficients; RCM on the scrambled 1024^2 system against
   scipy's (no wider); (b) that scrambled Laplacian written to a
   Matrix Market file and read back exactly, built on the card from the
   file and from memory: f32 CG solve(200) bit for bit, K8 or K9 launched
   200 times; (c) 2-D CG at 4096^2 on 1 and 4 pieces: solve(100),
   ``save_checkpoint``, ``load_checkpoint`` into a fresh solver, whose
   solve(100) is the first one's next solve(100) bit for bit (history and
   x).  ``--utils`` runs 4o alone.
4p. the main path over two processes sharing the card (gloo, 2 of the 4
   shards each, through ``initialize_distributed``): (a) 2-D CG at
   4096^2, s-step and two-pass, solve(200): history and x bit for bit the
   one-process 4-piece mesh's on both ranks, each process's K1/K2 and
   K3/K4 launches half of one process's; (b) the explicit 2048^2
   Laplacian on the DiaOperator (K8 per piece) and (c) on the sharded ELL
   (K9 per piece): one matvec bit for bit, the solve(200) history and x
   within phase 4k's envelope against float64 CG; (d) the f64 golden
   exactly; (e) the fused 2-D BiCGStab at 4096^2 and (f) the block CG
   (s-step phases) and block BiCGStab of 2 spaces (b = 1 and 2) at 4096^2,
   solve(100): history and x bit for bit the one-process mesh's, each
   process's K5a-c (K1/K2 for block CG) launches half of one process's;
   (g) GMRES(10) for 3 cycles on the 4096^2 stencil (history within 2e-4
   of one process's, 4j's rule) and PCG(Jacobi) solve(100) on (b)'s
   DiaOperator (within phase 4k's envelope of one process and of float64
   CG), equal on both ranks, half the launches; (h) ``entry.entry()``'s
   step on the card against the same step on the CPU, and
   ``entry.dryrun_multichip(4)`` on the one-process mesh and across the
   workers: every number equal on both ranks, the fused sections bit for
   bit one process's, the others within 1e-4; (i) 3-D pieces at 256^3
   (-dim 3, 4): two-pass CG solve(100), history and x bit for bit, each
   process's K6a pq/update and K6b launches half of one process's; one
   27-point matvec bit for bit; BiCGStab step() on the 7-point stencil
   within phase 4j's eager bound; (j) the 1-D view at 2^24 ([4096,
   4096]): two-pass CG and the fused BiCGStab solve(100) bit for bit
   (the s-step takes no 1-D pieces, on one process either), half the
   K3/K4 and K5a-c launches; (k) the scrambled 2048^2 Laplacian of 4f
   through the planner's RCM upgrade: one process's chain and
   permutation on both ranks, CG solve(200) within phase 4k's envelope
   of one process and of float64 CG, x in the natural order, half the K9
   launches, the host build seconds per rank; the ms/iter beside one
   process's (timed solves of 25 iterations).  ``--processes`` runs 4p
   alone.

To make room for 4m and 5m, phase 5j's and 5k's idle traces covered about
2000 glue operations each, a third of what they did; to make room for 4p
(i)-(k), about TRACE_OPS (1000), at least a TRACE_SHARE-th (a twentieth,
from a tenth) of each timed solve.

The line before the last is one JSON object describing every kernel
(``ms_lost``: launches x (ms - bound_ms) over the main path's launches,
a launch on one of S pieces counted as 1/S of a whole-grid launch);
the last line is ``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import time

N_GRID = 4096
ACCURACY_GRIDS = (2048, 3001)  # 2-D CG held to float64 at these sizes too
RAGGED = (200, 328)
SMALL_GRID = 256
N_EAGER = 3
OFFS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
KW = dict(offsets=OFFS, values=VALS)
CSRC = "legionsolvers_tpu_torch/csrc/stencil2d.cu"
PALLAS = "legionsolvers_tpu/ops/pallas/stencil2d.py"
# pass name -> (wrapper, pallas_call line it replaces, bytes per element)
KERNELS = {
    "y": ("grid2d_stencil_matvec", 333, 8),
    "y_dot": ("grid2d_stencil_matvec(with_dot)", 333, 8),
    "pq": ("grid2d_cg_pq", 333, 4),
    "update": ("grid2d_cg_update", 333, 20),
    "xpay_pq": ("grid2d_cg_xpay_pq", 583, 12),
    "gram2": ("grid2d_cg_gram2", 1107, 8),
    "step2": ("grid2d_cg_step2", 1107, 24),
}
BICG_CSRC = "legionsolvers_tpu_torch/csrc/bicgstab2d.cu"
BICG_PALLAS = "legionsolvers_tpu/ops/pallas/bicgstab2d.py"
# BiCGStab pass (= wrapper) name -> (pallas_call line it replaces, B/elt)
BICG_KERNELS = {"bicg_pv": (310, 24), "bicg_st": (395, 8),
                "bicg_update": (487, 28)}
N_ITERS = 200
# leading history entries (the initial one and two iterations) over which
# two f32 BiCGStab codes that round the vector updates differently are held
# together; past them the 4096^2 recurrence amplifies a 1e-7 difference
# ~1e3-fold per iteration
N_AGREE = 3
CONTINUE_AT = (0, 50, 100, 150, 199)

# the 3-D path: -dim 3 (7-point) and 4 (27-point) at 256^3, the JAX bench
# matrix's size (scripts/bench_matrix.py:25-30)
SHAPE3 = (256, 256, 256)
RAGGED3 = (37, 45, 130)
DIMS3 = (3, 4)
CSRC3 = "legionsolvers_tpu_torch/csrc/stencil3d.cu"
PALLAS3 = "legionsolvers_tpu/ops/pallas/stencil3d.py"
KERNELS3 = {
    "y3d": ("grid3d_stencil_matvec", 334, 8),
    "y_dot3d": ("grid3d_stencil_matvec(with_dot)", 334, 8),
    "pq3d": ("grid3d_cg_pq", 334, 4),
    "update3d": ("grid3d_cg_update", 334, 20),
    "xpay_pq3d": ("grid3d_cg_xpay_pq", 495, 12),
}
BICG3_CSRC = "legionsolvers_tpu_torch/csrc/bicgstab3d.cu"
BICG3_PALLAS = "legionsolvers_tpu/ops/pallas/bicgstab3d.py"
BICG3_KERNELS = {"bicg3d_pv": (243, 24), "bicg3d_st": (243, 8),
                 "bicg3d_update": (243, 28)}
# The passes on the reach-1 register march (march1), every 3-D pass: each
# is one launch, its dots folded into its last block, but K7 update with
# compensated dots, which runs march3d and a second launch
# (reduce_partials) for its dots (csrc/bicgstab3d.cu says why); with
# REACH2 each runs the window march (one launch, likewise):
# ops/cuda/stencil3d.route3d.
MARCH1_PASSES = ("y3d", "y_dot3d", "pq3d", "update3d", "xpay_pq3d",
                 "bicg3d_pv", "bicg3d_st", "bicg3d_update")
# each march1 pass's label in march1_attrs
M1_ATTR_NAMES = {"y3d": "y", "y_dot3d": "y_dot", "pq3d": "pq",
                 "update3d": "update", "xpay_pq3d": "xpay_pq",
                 "bicg3d_pv": "pv", "bicg3d_st": "st",
                 "bicg3d_update": "bicg_update"}
# A reach-2 stencil (the 11-point star with arms of 2 in y and z; |ox| <= 1
# is the gate's) that phase 3c runs off march1 (the window march)
REACH2 = "reach2"
REACH2_KW = dict(
    offsets=((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 0, -1),
             (0, 1, 0), (0, 0, 1), (0, -2, 0), (0, 0, -2), (0, 2, 0),
             (0, 0, 2)),
    values=(7.5, -1.0, -1.0) + (-4.0 / 3.0,) * 4 + (1.0 / 12.0,) * 4)
# the 3-D solve(200)s of --solves: name -> (solver, -dim)
SOLVES3 = {"cg3d_7": ("cg", 3), "cg3d_27": ("cg", 4),
           "bicg3d_7": ("bicg", 3), "bicg3d_27": ("bicg", 4)}
# launches of each 3-D pass in one solve(200) of the main path's schedule
SOLVE3_LAUNCHES = {"cg": {"pq3d": 1, "update3d": 200, "xpay_pq3d": 199},
                   "bicg": {"bicg3d_pv": 200, "bicg3d_st": 200,
                            "bicg3d_update": 200}}
NAMES3 = {"y3d": ("y",), "y_dot3d": ("y", "dot"), "pq3d": ("dot",),
          "update3d": ("x", "r", "dot"), "xpay_pq3d": ("p", "dot"),
          "bicg3d_pv": ("p", "v", "rtv"), "bicg3d_st": ("ts", "tt"),
          "bicg3d_update": ("x", "r", "rr", "rtr")}
# Bounds of the 3-D solves, set from what f32 arithmetic itself does on
# these systems (textbook f32 against float64 on an H100; PERF.md §6):
# textbook f32 CG is 1.5e-4 off float64 CG by iteration 3, so eager step()s
# and the fused solve, which sum in other orders, are held to 1e-5 over the
# first two history entries and 1e-3 over the first N_EAGER + 1; 27-point
# f32 CG ends with ||b - Ax||^2 13.7% off its recurrence residual (textbook
# f32 too), so the kernel path's gap is held to twice textbook f32's, or
# 1e-3; f32 BiCGStab's recurrence is held to ||b - Ax||^2 after GAP_ITERS
# iterations, while its residual is far above f32's attainable accuracy.
EAGER3_RTOL = (1e-5, 1e-3)
CG3_GAP_FLOOR = 1e-3
CG3_F64_FLOOR = 1e-4
GAP_ITERS = 20
BICG3_GAP = 1e-3
BICG3_X_FLOOR = 1e-3

# f32 peak outside the tensor cores of one H100 SXM at 700 W (NVIDIA's data
# sheet), for the operations side of each kernel's bound
F32_PEAK = 67e12
# per pass: (stencil applications, other f32 operations) per element
PASS_OPS = {"y": (1, 0), "y_dot": (1, 2), "pq": (1, 2), "update": (1, 6),
            "xpay_pq": (1, 4), "gram2": (3, 20), "step2": (5, 40),
            "bicg_pv": (1, 6), "bicg_st": (1, 6), "bicg_update": (1, 12)}


def ops_per_elt(name, n_terms):
    apps, other = PASS_OPS[name.replace("3d", "")]
    return 2 * n_terms * apps + other


def log(*a):
    print(*a, flush=True)


def max_sm_clock_hz():
    """The card's maximum SM clock (``nvidia-smi``'s clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def make_inputs(torch, T, shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    R, C = shape
    d = {k: torch.randn(shape, generator=g, device=device)
         for k in ("x", "r", "p")}
    for k in ("rt", "rb", "pt", "pb"):
        d[k] = torch.randn(8, C, generator=g, device=device)
    d["alpha"] = torch.tensor(0.3, device=device)
    d["beta"] = torch.tensor(0.2, device=device)
    d["coef"] = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], **KW))[0]
    return d


def one_pass_call(T, mode, d, plain, kw=KW):
    """A closure running one K3 mode or K4 on ``d`` in place (update writes
    d's x and r), with d's halo blocks (None: zeros): the wrapper (kernel
    on CUDA tensors) or the plain version.  It returns the pass's outputs:
    (y,), (y, dot), (dot,), (x, r, dot) or (p, dot)."""
    if mode in ("y", "y_dot", "pq"):
        src = d["p"] if mode == "pq" else d["x"]
        top, bot = (d["pt"], d["pb"]) if mode == "pq" else (d["rt"], d["rb"])
        if plain:
            return lambda: T.stencil_plain(mode, src, top, bot, **kw)
        if mode == "pq":
            return lambda: (T.grid2d_cg_pq(src, top, bot, **kw),)
        if mode == "y":
            return lambda: (T.grid2d_stencil_matvec(src, top, bot, **kw),)
        return lambda: T.grid2d_stencil_matvec(src, top, bot, with_dot=True,
                                               **kw)
    if mode == "update":
        if plain:
            return lambda: T.stencil_plain(
                "update", d["p"], d["pt"], d["pb"],
                (d["x"], d["r"], d["alpha"]), **kw)
        return lambda: T.grid2d_cg_update(d["p"], d["x"], d["r"], d["alpha"],
                                          d["pt"], d["pb"], **kw)
    fn = T.xpay_pq_plain if plain else T.grid2d_cg_xpay_pq
    return lambda: fn(d["r"], d["p"], d["beta"], d["rt"], d["rb"], d["pt"],
                      d["pb"], **kw)


ONE_PASS_NAMES = {"y": ("y",), "y_dot": ("y", "dot"), "pq": ("dot",),
                  "update": ("x", "r", "dot"), "xpay_pq": ("p", "dot")}


def run_mode(T, mode, d, plain, kw=KW):
    """One pass on fresh copies of ``d``: the wrapper (kernel on CUDA
    tensors) or the plain version.  Returns {output name: tensor}."""
    c = {k: None if v is None else v.clone() for k, v in d.items()}
    if mode in ONE_PASS_NAMES:
        return dict(zip(ONE_PASS_NAMES[mode],
                        one_pass_call(T, mode, c, plain, kw)()))
    if mode == "gram2":
        fn = T.gram2_plain if plain else T.grid2d_cg_gram2
        return {"gram": fn(c["r"], c["p"], **kw)}
    fn = T.step2_plain if plain else T.grid2d_cg_step2
    out = fn(c["x"], c["r"], c["p"], c["coef"], **kw)
    return dict(zip(("x", "r", "p", "gram"), out))


def dot_scales(torch, T, mode, d, ref):
    """sqrt(<a,a><b,b>) for each dot the pass returns (float64)."""
    A = lambda v, top=None, bot=None: T.apply_plain(v, OFFS, VALS, top, bot)
    nrm = lambda v: torch.linalg.vector_norm(v.double()).item()
    if mode == "y_dot":
        return nrm(d["x"]) * nrm(ref["y"])
    if mode == "pq":
        return nrm(d["p"]) * nrm(A(d["p"], d["pt"], d["pb"]))
    if mode == "update":
        return nrm(ref["r"]) ** 2
    if mode == "xpay_pq":
        b = d["beta"]
        return nrm(ref["p"]) * nrm(A(ref["p"], d["rt"] + b * d["pt"],
                                     d["rb"] + b * d["pb"]))
    r, p = (ref["r"], ref["p"]) if mode == "step2" else (d["r"], d["p"])
    Ap, Ar = A(p), A(r)
    n = {"r": nrm(r), "p": nrm(p), "Ap": nrm(Ap), "Ar": nrm(Ar),
         "A2p": nrm(A(Ap))}
    pairs = ("r r", "p Ap", "r Ap", "Ap Ap", "r Ar", "Ap Ar", "Ap A2p",
             "Ar Ar", "Ar A2p", "A2p A2p")
    return torch.tensor([n[a] * n[b] for a, b in map(str.split, pairs)],
                        dtype=torch.float64)


def compare_kernels(torch, T, device):
    """Phase 3.  Returns {mode: max abs error over both shapes}."""
    errs = {}
    for shape in ((N_GRID, N_GRID), RAGGED):
        for mode in KERNELS:
            d = make_inputs(torch, T, shape, 17, device)
            got = run_mode(T, mode, d, plain=False)
            ref = run_mode(T, mode, d, plain=True)
            torch.cuda.synchronize()
            worst = scale_max = 0.0
            for key, want in ref.items():
                have, want = got[key].double(), want.double()
                err = (have - want).abs()
                worst = max(worst, err.max().item())
                scale_max = max(scale_max, want.abs().max().item())
                if key in ("dot", "gram"):
                    scale = dot_scales(torch, T, mode, d, ref)
                    ok = bool((err.cpu() <= 1e-4 * torch.as_tensor(scale))
                              .all())
                else:
                    ok = err.max().item() <= 1e-5 * want.abs().max().item()
                if not ok:
                    raise AssertionError(
                        f"{mode} {shape} {key}: kernel disagrees with its "
                        f"plain version (max abs err {err.max().item():g})")
            errs[mode] = max(errs.get(mode, 0.0), worst)
            log(f"[check] {mode:8s} {shape}: kernel == plain "
                f"(max abs err {worst:.3g}, max |output| {scale_max:.3g})")
    return errs


# K1 at the edges of its 120-column strips, its row chunks and its 16-byte
# vectors (C % 4 != 0 takes scalar loads), with the main path's cross and a
# 9-point reach-1 stencil (terms not in box order: the kernel's switch
# path)
STEP2_SHAPES = ((N_GRID, N_GRID), RAGGED, (33, 4097), (4099, 130), (1, 5))
OFFS9 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1),
         (1, -1), (1, 1))
VALS9 = (6.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5, -0.5, -0.5)


def gram_scales(torch, T, r, p, kw):
    """sqrt(<a,a><b,b>) of each Gram entry of (r, p) (float64)."""
    A = lambda v: T.apply_plain(v, kw["offsets"], kw["values"])
    nrm = lambda v: torch.linalg.vector_norm(v.double()).item()
    Ap, Ar = A(p), A(r)
    n = {"r": nrm(r), "p": nrm(p), "Ap": nrm(Ap), "Ar": nrm(Ar),
         "A2p": nrm(A(Ap))}
    pairs = ("r r", "p Ap", "r Ap", "Ap Ap", "r Ar", "Ap Ar", "Ap A2p",
             "Ar Ar", "Ar A2p", "A2p A2p")
    return torch.tensor([n[a] * n[b] for a, b in map(str.split, pairs)],
                        dtype=torch.float64)


def compare_step2_edges(torch, T, device):
    """Phase 3, K1 at STEP2_SHAPES with the cross and the 9-point stencil,
    against step2_plain to phase 3's bounds, and a repeat of the kernel on
    the same inputs, bit for bit (the last block's Gram fold is
    deterministic).  Returns the max abs error."""
    worst_all = 0.0
    for kw in (KW, dict(offsets=OFFS9, values=VALS9)):
        for shape in STEP2_SHAPES:
            g = torch.Generator(device=device).manual_seed(29)
            d = {k: torch.randn(shape, generator=g, device=device)
                 for k in ("x", "r", "p")}
            coef = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], **kw))[0]
            runs = []
            for fn in (T.grid2d_cg_step2, T.grid2d_cg_step2, T.step2_plain):
                c = {k: v.clone() for k, v in d.items()}
                runs.append(fn(c["x"], c["r"], c["p"], coef, **kw))
            torch.cuda.synchronize()
            (k1, k2, ref), worst = runs, 0.0
            if not all(torch.equal(a, b) for a, b in zip(k1, k2)):
                raise AssertionError(f"step2 {shape} {len(kw['offsets'])}-"
                                     "point: a repeat is not bit-identical")
            for name, have, want in zip("xrp", k1[:3], ref[:3]):
                err = (have.double() - want.double()).abs().max().item()
                worst = max(worst, err)
                if not err <= 1e-5 * want.abs().max().item():
                    raise AssertionError(
                        f"step2 {shape} {len(kw['offsets'])}-point {name}: "
                        f"kernel disagrees with its plain version ({err:g})")
            gerr = (k1[3].double() - ref[3].double()).abs().cpu()
            if not bool((gerr <= 1e-4 * gram_scales(torch, T, ref[1], ref[2],
                                                    kw)).all()):
                raise AssertionError(
                    f"step2 {shape} {len(kw['offsets'])}-point gram: kernel "
                    f"disagrees with its plain version ({gerr.max():g})")
            worst = max(worst, gerr.max().item())
            worst_all = max(worst_all, worst)
            log(f"[check] step2    {shape} {len(kw['offsets'])}-point: "
                f"kernel == plain (max abs err {worst:.3g}); repeat bit "
                "for bit")
            del d, runs, k1, k2, ref
    return worst_all


# K5b (bicg_st) and K2 (gram2) on the column-strip march, at K1's edge
# shapes, with the cross, the 9-point stencil and (K5b) a reach-2 cross
# with arms of 2, which runs the band route
STRIP_SHAPES = (RAGGED, (33, 4097), (4099, 130), (1, 5), (96, 132))
OFFS_R2 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, 0), (2, 0),
           (0, -2), (0, 2))
VALS_R2 = (5.0, -1.0, -1.0, -1.0, -1.0, -0.25, -0.25, -0.25, -0.25)
STRIP_STENCILS = {"cross": (OFFS, VALS), "9-point": (OFFS9, VALS9),
                  "reach2": (OFFS_R2, VALS_R2)}


def compare_strip_edges(torch, T, TB, device):
    """Phase 3, K5b (compensated dots off and on) and K2 at STRIP_SHAPES
    with STRIP_STENCILS (K2: reach 1 only) against their plain versions to
    phase 3's bounds (each dot to 1e-4 of its Cauchy-Schwarz scale), and a
    repeat of the kernel on the same inputs, bit for bit.  Returns
    {pass name: max abs error}."""
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = {"bicg_st": 0.0, "gram2": 0.0}
    for sname, (offs, vals) in STRIP_STENCILS.items():
        kw = dict(offsets=offs, values=vals)
        for shape in STRIP_SHAPES:
            g = torch.Generator(device=device).manual_seed(41)
            r, v = (torch.randn(shape, generator=g, device=device)
                    for _ in range(2))
            s = r - torch.tensor(0.83, device=device) * v
            t = T.apply_plain(s, offs, vals)
            scale = torch.tensor([nrm(t) * nrm(s), nrm(t) ** 2],
                                 dtype=torch.float64)
            worst = 0.0
            for comp in (False, True):
                k1, k2, ref = (torch.stack(fn(r, v, 0.83, compensated=comp,
                                              **kw)).double().cpu()
                               for fn in (TB.bicg_st, TB.bicg_st,
                                          TB.bicg_st_plain))
                err = (k1 - ref).abs()
                if not torch.equal(k1, k2):
                    raise AssertionError(f"bicg_st {shape} {sname} "
                                         f"compensated={comp}: a repeat is "
                                         "not bit-identical")
                if not bool((err <= 1e-4 * scale).all()):
                    raise AssertionError(
                        f"bicg_st {shape} {sname} compensated={comp}: kernel "
                        f"disagrees with its plain version ({err.max():g})")
                worst = max(worst, err.max().item())
            errs["bicg_st"] = max(errs["bicg_st"], worst)
            done = "bicg_st"
            if sname != "reach2":
                g1, g2, gref = (fn(r, v, **kw).double().cpu() for fn in (
                    T.grid2d_cg_gram2, T.grid2d_cg_gram2, T.gram2_plain))
                gerr = (g1 - gref).abs()
                if not torch.equal(g1, g2):
                    raise AssertionError(f"gram2 {shape} {sname}: a repeat "
                                         "is not bit-identical")
                if not bool((gerr <= 1e-4 * gram_scales(torch, T, r, v, kw))
                            .all()):
                    raise AssertionError(
                        f"gram2 {shape} {sname}: kernel disagrees with its "
                        f"plain version ({gerr.max():g})")
                errs["gram2"] = max(errs["gram2"], gerr.max().item())
                worst = max(worst, gerr.max().item())
                done += ", gram2"
            log(f"[check] {done} {shape} {sname}: kernel == plain (max abs "
                f"err {worst:.3g}); repeat bit for bit")
    return errs


def one_pass_inputs(torch, shape, halos, device, seed=43):
    """x, r, p on ``shape``, random [8, C] halo blocks (None without
    ``halos``), alpha and beta, for K3 and K4."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = {k: torch.randn(shape, generator=g, device=device)
         for k in ("x", "r", "p")}
    for k in ("rt", "rb", "pt", "pb"):
        d[k] = (torch.randn(8, shape[1], generator=g, device=device)
                if halos else None)
    d["alpha"] = torch.tensor(0.3, device=device)
    d["beta"] = torch.tensor(0.2, device=device)
    return d


def compare_one_pass_edges(torch, T, device):
    """Phase 3, K3 (four modes) and K4 at STRIP_SHAPES with STRIP_STENCILS
    (reach 1: the strip kernels; reach 2: the band route), without and
    with random halo blocks, against their plain versions to phase 3's
    bounds (elementwise 1e-5 * max|ref|, each dot 1e-4 of its
    Cauchy-Schwarz scale), and a repeat of the kernel on the same inputs,
    bit for bit.  Returns {pass name: max abs error}."""
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = dict.fromkeys(ONE_PASS_NAMES, 0.0)
    for sname, (offs, vals) in STRIP_STENCILS.items():
        kw = dict(offsets=offs, values=vals)
        A = lambda v, top, bot: T.apply_plain(v, offs, vals, top, bot)
        for shape in STRIP_SHAPES:
            for halos in (False, True):
                d = one_pass_inputs(torch, shape, halos, device)
                comb = lambda a, b: None if a is None else a + d["beta"] * b
                worst = 0.0
                for mode in ONE_PASS_NAMES:
                    k1, k2, ref = (run_mode(T, mode, d, plain, kw)
                                   for plain in (False, False, True))
                    torch.cuda.synchronize()
                    case = (f"{mode} {shape} {sname} halos="
                            f"{'random' if halos else 'null'}")
                    if not all(torch.equal(k1[k], k2[k]) for k in k1):
                        raise AssertionError(f"{case}: a repeat is not "
                                             "bit-identical")
                    for key, want in ref.items():
                        err = (k1[key].double() - want.double()).abs().max()
                        if key != "dot":
                            bound = 1e-5 * want.abs().max().item()
                        elif mode == "y_dot":
                            bound = 1e-4 * nrm(d["x"]) * nrm(ref["y"])
                        elif mode == "pq":
                            bound = 1e-4 * nrm(d["p"]) * nrm(
                                A(d["p"], d["pt"], d["pb"]))
                        elif mode == "update":
                            bound = 1e-4 * nrm(ref["r"]) ** 2
                        else:
                            bound = 1e-4 * nrm(ref["p"]) * nrm(A(
                                ref["p"], comb(d["rt"], d["pt"]),
                                comb(d["rb"], d["pb"])))
                        if not err.item() <= bound:
                            raise AssertionError(
                                f"{case} {key}: kernel disagrees with its "
                                f"plain version ({err.item():g})")
                        errs[mode] = max(errs[mode], err.item())
                        worst = max(worst, err.item())
                log(f"[check] K3, K4 {shape} {sname} halos="
                    f"{'random' if halos else 'null'}: kernel == plain (max "
                    f"abs err {worst:.3g}); repeat bit for bit")
                del d
    return errs


def check_one_launch_2d(torch, T, TB, device):
    """Phase 3: K5b with the reach-1 stencils (compensated dots off and on),
    K2, K3 (four modes) and K4 launch one kernel, their strip kernel, and
    no reduce_partials; K3, K4 and K5a-c with the reach-2 stencil one
    kernel, the band route's; K5a with the reach-1 stencils the tile
    kernel and its second launch, which shows that the trace sees a
    second launch.  Returns {case: kernel names}."""
    g = torch.Generator(device=device).manual_seed(37)
    r, v, rp, rt = (torch.randn(RAGGED, generator=g, device=device)
                    for _ in range(4))
    pv_out = (torch.empty_like(r), torch.empty_like(r))
    x5, r_out = torch.zeros_like(r), torch.empty_like(r)
    alpha = torch.tensor(0.83, device=device)  # as the solver passes it
    d = one_pass_inputs(torch, RAGGED, True, device, seed=47)
    d["alpha"] = d["alpha"] * 1e-3  # update runs in place, once per trace
    cases = {}
    for sname, (offs, vals) in STRIP_STENCILS.items():
        kw = dict(offsets=offs, values=vals)
        for c in (False, True):
            cases[f"bicg_st {sname} compensated={c}"] = (
                lambda c=c, kw=kw: TB.bicg_st(r, v, alpha, compensated=c,
                                              **kw))
            cases[f"bicg_pv {sname} compensated={c}"] = (
                lambda c=c, kw=kw: TB.bicg_pv(r, v, rp, rt, alpha, alpha,
                                              compensated=c, out=pv_out,
                                              **kw))
        if sname == "reach2":
            cases["bicg_update reach2"] = lambda kw=kw: TB.bicg_update(
                r, v, x5, rp, rt, alpha, alpha, out=r_out, **kw)
        if sname != "reach2":
            cases[f"gram2 {sname}"] = lambda kw=kw: T.grid2d_cg_gram2(r, v,
                                                                      **kw)
        for mode in ONE_PASS_NAMES:
            cases[f"{mode} {sname}"] = one_pass_call(T, mode, d, False, kw)
    seen, bad = {}, []
    for case, names in zip(cases, device_kernels(torch,
                                                 list(cases.values()))):
        seen[case] = names
        second = any("reduce_partials" in n for n in names)
        if case.startswith("bicg_pv") and "reach2" not in case:
            ok = second
        elif "reach2" in case:
            ok = len(names) == 1 and "band_pass_kernel" in names[0]
        else:
            ok = len(names) == 1 and "strip_kernel" in names[0]
        if not ok:
            bad.append((case, names))
    log("[check2d] one launch per strip and band pass: "
        + ("yes" if not bad else f"NO: {bad}") + "; e.g. "
        + "; ".join(f"{k}: {seen[k]}" for k in (
            "bicg_st cross compensated=False", "gram2 cross",
            "update 9-point", "xpay_pq cross", "pq reach2",
            "bicg_pv cross compensated=False",
            "bicg_st reach2 compensated=True", "bicg_update reach2")))
    if bad:
        raise AssertionError(f"strip and band passes with a second launch, "
                             f"or tile passes without one: {bad}")
    return seen


def strip_attrs(lib):
    """{kernel variant: [registers, spill bytes, resident blocks per SM]}
    of K5b's, K2's, K3's and K4's strip kernels (cudaFuncGetAttributes and
    the occupancy calculator on this card)."""
    import ctypes

    def k5b(which):
        return f"bicg_st{' compensated' if which & 4 else ''}"

    k3 = lambda which: ("y", "y_dot", "pq", "update")[which >> 2]
    out, res = (ctypes.c_int * 3)(), {}
    for fn, n, name in (("ls_bicg_st_strip_attrs", 8, k5b),
                        ("ls_gram2_attrs", 4, lambda _: "gram2"),
                        ("ls_stencil2d_strip_attrs", 16, k3),
                        ("ls_xpay_pq_strip_attrs", 4, lambda _: "xpay_pq")):
        for which in range(n):
            err = getattr(lib, fn)(which, out)
            if err:
                raise RuntimeError(f"{fn}({which}): CUDA error {err}")
            label = (f"{name(which)} {'cross' if which & 2 else 'stencil'} "
                     f"{'vec' if which & 1 else 'scalar'}")
            res[label] = list(out)
    return res


def bicg_inputs(torch, shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    d = {k: torch.randn(shape, generator=g, device=device)
         for k in ("x", "r", "p", "v", "rt")}
    for k, val in (("alpha", 0.83), ("beta", 0.37), ("omega", 0.41)):
        d[k] = torch.tensor(val, device=device)
    return d


def bicg_call(TB, name, d, compensated, plain, out=None, kw=KW):
    """A closure running one K5 pass on ``d`` in place (x of update) with
    outputs to ``out``: the wrapper or its plain version."""
    kw = dict(kw, compensated=compensated)
    fn = getattr(TB, name + "_plain" if plain else name)
    if name == "bicg_pv":
        return lambda: fn(d["r"], d["p"], d["v"], d["rt"], d["beta"],
                          d["omega"], out=out, **kw)
    if name == "bicg_st":
        return lambda: fn(d["r"], d["v"], d["alpha"], **kw)
    return lambda: fn(d["r"], d["v"], d["x"], d["p"], d["rt"], d["alpha"],
                      d["omega"], out=out, **kw)


def run_bicg(TB, name, d, compensated, plain, kw=KW):
    """One K5 pass on fresh copies of ``d``: {output name: tensor}."""
    c = {k: v.clone() for k, v in d.items()}
    names = {"bicg_pv": ("p", "v", "rtv"), "bicg_st": ("ts", "tt"),
             "bicg_update": ("x", "r", "rr", "rtr")}[name]
    return dict(zip(names, bicg_call(TB, name, c, compensated, plain,
                                      kw=kw)()))


def bicg_operands(T, name, d, outs, kw=KW):
    """The f32 operand pair of each dot of a K5 pass: v' or r' from
    ``outs``, s = r - alpha v and t = A s formed by the plain version."""
    if name == "bicg_pv":
        return {"rtv": (d["rt"], outs["v"])}
    if name == "bicg_update":
        return {"rr": (outs["r"], outs["r"]), "rtr": (d["rt"], outs["r"])}
    s = d["r"] - d["alpha"] * d["v"]
    t = T.apply_plain(s, kw["offsets"], kw["values"])
    return {"ts": (t, s), "tt": (t, t)}


def compare_bicg_kernels(torch, T, TB, device):
    """Phase 3b: K5 against its plain version, compensated dots off and on.
    Same bounds as phase 3; under compensation each dot is also held within
    4e-7 relative of the float64 sum of its f32 operands (the f32 rounding
    of an exactly accumulated sum, test_25's bound).  Returns {name: max
    abs error}."""
    f64dot = lambda a, b: torch.dot(a.double().reshape(-1),
                                    b.double().reshape(-1)).item()
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = {}
    for shape in ((N_GRID, N_GRID), RAGGED):
        d = bicg_inputs(torch, shape, 23, device)
        for comp in (False, True):
            for name in BICG_KERNELS:
                got = run_bicg(TB, name, d, comp, plain=False)
                ref = run_bicg(TB, name, d, comp, plain=True)
                torch.cuda.synchronize()
                ops = bicg_operands(T, name, d, ref)
                worst = 0.0
                for key, want in ref.items():
                    err = (got[key].double() - want.double()).abs().max()
                    worst = max(worst, err.item())
                    if want.dim():
                        ok = err.item() <= 1e-5 * want.abs().max().item()
                    else:
                        a, b = ops[key]
                        ok = err.item() <= 1e-4 * nrm(a) * nrm(b)
                    if not ok:
                        raise AssertionError(
                            f"{name} {shape} compensated={comp} {key}: "
                            f"kernel disagrees with its plain version "
                            f"(max abs err {err.item():g})")
                exact_rel = 0.0
                if comp:
                    for key, (a, b) in bicg_operands(T, name, d, got).items():
                        exact = f64dot(a, b)
                        rel = abs(got[key].item() - exact) / abs(exact)
                        exact_rel = max(exact_rel, rel)
                        if rel > 4e-7:
                            raise AssertionError(
                                f"{name} {shape} {key}: compensated dot "
                                f"{rel:g} off the float64 sum")
                errs[name] = max(errs.get(name, 0.0), worst)
                log(f"[check] {name:11s} {shape} compensated={comp}: "
                    f"kernel == plain (max abs err {worst:.3g}"
                    + (f"; dots vs float64 sum max rel {exact_rel:.3g})"
                       if comp else ")"))
        del d
    return errs


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

class plain_driven:
    """Within the block, ``solver``'s passes run their plain versions on
    CUDA tensors: the wrappers named in ``plain`` are swapped on ``module``,
    and the solver's cached runners (which hold the wrappers they were
    built with) are dropped on the way in and out."""

    def __init__(self, module, solver, plain):
        self.module, self.solver, self.plain = module, solver, plain

    def __enter__(self):
        self.saved = {k: getattr(self.module, k) for k in self.plain}
        for k, fn in self.plain.items():
            setattr(self.module, k, fn)
        drop_runners(self.solver)

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(self.module, k, fn)
        drop_runners(self.solver)


class env_route:
    """Within the block, the environment switch ``name`` is set (e.g.
    LEGIONSOLVERS_NO_SSTEP: the two-pass CG schedule; None: nothing), and
    the ``solvers``' cached runners, built under the other route, are
    dropped on the way in and out."""

    def __init__(self, name, *solvers):
        self.name, self.solvers = name, solvers

    def __enter__(self):
        if self.name:
            os.environ[self.name] = "1"
        drop_runners(*self.solvers)

    def __exit__(self, *exc):
        if self.name:
            del os.environ[self.name]
        drop_runners(*self.solvers)


def cg_plain(T):
    """The plain versions of the CG path's wrappers, by wrapper name."""
    return {
        "grid2d_stencil_matvec": lambda x, top=None, bot=None, *,
        with_dot=False, out=None, **kw: (
            T.stencil_plain("y_dot", x, top, bot, out=out, **kw) if with_dot
            else T.stencil_plain("y", x, top, bot, out=out, **kw)[0]),
        "grid2d_cg_pq": lambda p, top=None, bot=None, **kw:
            T.stencil_plain("pq", p, top, bot, **kw)[0],
        "grid2d_cg_update": lambda p, x, r, alpha, top=None, bot=None,
        **kw: T.stencil_plain("update", p, top, bot, (x, r, alpha), **kw),
        "grid2d_cg_xpay_pq": T.xpay_pq_plain,
        "grid2d_cg_gram2": T.gram2_plain,
        "grid2d_cg_step2": T.step2_plain,
    }


def bicg_plain(TB):
    return {k: getattr(TB, k + "_plain") for k in BICG_KERNELS}


def restart(solver):
    solver.planner.zero_fill(solver.SOL)
    solver.reset()


def drop_runners(*solvers):
    """Drop the solvers' cached runners (GMRES and PCG keep none)."""
    for s in solvers:
        getattr(s, "_solve_cache", {}).clear()


def lap5(v):
    """The 5-point negative Laplacian with zero boundary, numpy or torch."""
    out = 4.0 * v
    out[1:, :] -= v[:-1, :]
    out[:-1, :] -= v[1:, :]
    out[:, 1:] -= v[:, :-1]
    out[:, :-1] -= v[:, 1:]
    return out


def classic_cg(xp, shape, iters, dtype=None, device=None, matvec=lap5,
               rhs=None):
    """Textbook CG on ``matvec`` (default the 5-point Laplacian) over a
    grid of ``shape``, b = 1 (torch: ``rhs`` where given, rounded to
    ``dtype``), in numpy (``xp`` = numpy, float64) or torch (``xp`` =
    torch, ``dtype`` on ``device``): (history, x), both float64."""
    if device is None:
        b = xp.ones(shape)
    elif rhs is not None:
        b = rhs.to(dtype)
    else:
        b = xp.ones(shape, dtype=dtype, device=device)
    x, r, p = b * 0, b * 1, b * 1
    rr = (r * r).sum()
    hist = [rr]
    for _ in range(iters):
        q = matvec(p)
        a = rr / (p * q).sum()
        x += a * p
        r -= a * q
        rr_new = (r * r).sum()
        hist.append(rr_new)
        p = r + (rr_new / rr) * p
        rr = rr_new
    if device is None:
        return xp.array(hist), x
    return xp.stack(hist).double(), x.double()


def cg2d_accuracy(torch, T, lt, n, device):
    """Distance from float64 CG of three f32 solve(200)s of the 2-D
    Laplacian at n^2: textbook f32 CG, and the s-step schedule driven by
    the kernels and by the plain versions.  {label: (max relative
    deviation of the history, max |x - x64| / max |x64|)}."""
    from legionsolvers_tpu_torch.entry import build_system

    planner = build_system(n, lt.SolverOptions(entry_dtype=torch.float32),
                           device)
    solver = lt.CGSolver(planner)
    h64, x64 = classic_cg(torch, (n, n), N_ITERS, torch.float64, device)
    h32, x32 = classic_cg(torch, (n, n), N_ITERS, torch.float32, device)

    def dist(h, x):
        xd = (x.double().reshape(n, n) - x64).abs().max() / x64.abs().max()
        return ((h.double() - h64) / h64).abs().max().item(), xd.item()

    env = {"textbook f32": dist(h32, x32)}
    restart(solver)
    env["kernel"] = dist(solver.solve(N_ITERS), planner.sol_vectors[0].data)
    with plain_driven(T, solver, cg_plain(T)):
        restart(solver)
        env["plain"] = dist(solver.solve(N_ITERS),
                            planner.sol_vectors[0].data)
    return env


def main_path(torch, np, T, lt, device):
    """Phase 4.  Returns (launch counts of the main-path run, results,
    the solver)."""
    from legionsolvers_tpu_torch.entry import build_system

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    planner = build_system(N_GRID, f32, device)
    op = planner.row_partitioned_matrices[0][0]
    if not (op.uses_pallas and op.step2_eligible):
        raise AssertionError("the 4096^2 operator is not on the kernel view")
    solver = lt.CGSolver(planner)
    torch.cuda.synchronize()

    T.reset_launch_counts()
    for _ in range(N_EAGER):
        solver.step()
    eager_hist = torch.stack([s.value for s in solver.residual_norm_squared])
    restart(solver)
    hist200 = solver.solve(200)
    after200 = dict(T.LAUNCHES)
    x200 = planner.sol_vectors[0].data.clone()
    restart(solver)
    hist201 = solver.solve(201)
    after201 = dict(T.LAUNCHES)
    # the two-pass schedule (K3 pq, then K4 xpay_pq + K3 update per
    # iteration), the same solve(200) again from the same state
    with env_route("LEGIONSOLVERS_NO_SSTEP", solver):
        restart(solver)
        hist_two_pass = solver.solve(N_ITERS)
        x_two_pass = planner.sol_vectors[0].data.clone()
        planner.matvec(solver.Q, solver.SOL)  # A x of the two-pass solve
        torch.cuda.synchronize()
        counts = dict(T.LAUNCHES)
        T.reset_launch_counts()
        restart(solver)
        hist_again = solver.solve(N_ITERS)
        torch.cuda.synchronize()
        again = dict(T.LAUNCHES)
        T.reset_launch_counts()
        same = (torch.equal(hist_again, hist_two_pass)
                and torch.equal(planner.sol_vectors[0].data, x_two_pass))

    want200 = {"y_dot": N_EAGER, "step2": 100, "gram2": 7}
    if after200 != want200:
        raise AssertionError(f"launches after solve(200): {after200}")
    want201 = {"y_dot": N_EAGER, "step2": 200, "gram2": 14, "update": 1}
    if after201 != want201:
        raise AssertionError(f"launches after solve(201): {after201}")
    want_two = {"pq": 1, "update": N_ITERS, "xpay_pq": N_ITERS - 1}
    want = dict(want201, update=1 + N_ITERS, pq=1, xpay_pq=N_ITERS - 1, y=1)
    if counts != want:
        raise AssertionError(f"main-path launches {counts} != {want}")
    if again != want_two:
        raise AssertionError(f"two-pass solve(200) launches {again} != "
                             f"{want_two}")
    log(f"[main] launches: {counts}")
    if not same:
        raise AssertionError("the two-pass solve(200) from the same state "
                             "is not bit-identical")

    for name, h in (("eager", eager_hist), ("solve(200)", hist200),
                    ("solve(201)", hist201), ("two-pass", hist_two_pass)):
        if not bool(torch.isfinite(h).all()):
            raise AssertionError(f"{name} history is not finite")
    # ||b - A x||^2 against the two-pass recurrence's last residual (checked
    # against textbook f32 CG's own gap below)
    b = planner.rhs_vectors[0].data
    res = torch.sum((b - planner.workspace_vectors[1][0].data).double() ** 2)
    rel = abs(res.item() - hist_two_pass[-1].item()) / hist_two_pass[-1].item()
    if not bool((b == 1.0).all()):
        raise AssertionError("the solve overwrote b")
    log(f"[main] solve(200) residual^2 {hist200[0].item():.6g} -> "
        f"{hist200[-1].item():.6g}; two-pass solve(200) repeats bit for "
        f"bit; its ||b-Ax||^2 off its history by {rel:.3g}")

    # the same schedule driven by the plain versions on the card.  f32 CG
    # on this system (kappa ~ 7e6) leaves exact arithmetic by ~3e-3 within
    # 200 iterations (textbook f32 CG against float64 CG on this card), so
    # two correct f32 implementations agree to 1e-3 only early on.  Kernel
    # and plain are held to 1e-3 over the iterations where textbook f32 CG
    # stays within half that of float64 CG; over all 200 the kernel path is
    # held to twice textbook f32 CG's distance from float64 CG.
    with plain_driven(T, solver, cg_plain(T)):
        restart(solver)
        hist_plain = solver.solve(200)
    x_plain = planner.sol_vectors[0].data.clone()
    if T.LAUNCHES:
        raise AssertionError("plain-driven solve launched kernels")
    rel_dev = lambda a, b: ((a.double() - b) / b).abs()
    h64, x64 = classic_cg(torch, (N_GRID, N_GRID), 200, torch.float64,
                          device)
    h32, x32 = classic_cg(torch, (N_GRID, N_GRID), 200, torch.float32,
                          device)
    off = (rel_dev(h32, h64) > 5e-4).nonzero()
    window = int(off[0]) if len(off) else len(h64)
    dev = rel_dev(hist200, hist_plain.double())[:window].max().item()
    if window < 2 or dev > 1e-3:
        raise AssertionError(f"kernel vs plain solve(200): first {window} "
                             f"history entries off by {dev:g}")
    xrel = lambda x: ((x.double() - x64).abs().max() / x64.abs().max()).item()
    env = {"textbook f32": (rel_dev(h32, h64).max().item(), xrel(x32)),
           "kernel": (rel_dev(hist200, h64).max().item(), xrel(x200)),
           "plain": (rel_dev(hist_plain, h64).max().item(), xrel(x_plain))}
    log(f"[main] kernel vs plain-driven solve(200): first {window} history "
        f"entries max rel {dev:.3g}; against float64 CG over 200 "
        "(history, x): " + ", ".join(
            f"{k} {h:.3g} {x:.3g}" for k, (h, x) in env.items()))
    if not (env["kernel"][0] <= 2 * env["textbook f32"][0]
            and env["kernel"][1] <= 2 * env["textbook f32"][1]):
        raise AssertionError("kernel-driven solve(200) is less accurate "
                             f"than twice textbook f32 CG: {env}")
    # the two-pass solve(200) to the same rule, and its ||b - Ax||^2 to its
    # history within twice textbook f32 CG's gap (or 1e-3, as phase 4c)
    two = (rel_dev(hist_two_pass, h64).max().item(), xrel(x_two_pass))
    rr32 = torch.sum((1.0 - lap5(x32)) ** 2).item()
    gap32 = abs(rr32 - h32[-1].item()) / h32[-1].item()
    log(f"[main] two-pass solve(200) against float64 CG (history, x): "
        f"{two[0]:.3g} {two[1]:.3g}; ||b-Ax||^2 gap {rel:.3g} (textbook "
        f"f32 {gap32:.3g})")
    if not (two[0] <= 2 * env["textbook f32"][0]
            and two[1] <= 2 * env["textbook f32"][1]):
        raise AssertionError("two-pass solve(200) is less accurate than "
                             f"twice textbook f32 CG: {two}, {env}")
    if rel > max(2 * gap32, CG3_GAP_FLOOR):
        raise AssertionError(f"two-pass ||b - Ax||^2 off its history by "
                             f"{rel:g}, textbook f32 CG by {gap32:g}")
    env["two-pass"] = two
    # the same bound at other sizes: 2048^2 on the 16-byte path, 3001^2
    # (odd width) on the scalar one
    env_n = {}
    for n in ACCURACY_GRIDS:
        env_n[n] = e = cg2d_accuracy(torch, T, lt, n, device)
        log(f"[main] {n}^2 solve(200) against float64 CG (history, x): "
            + ", ".join(f"{k} {h:.3g} {x:.3g}" for k, (h, x) in e.items()))
        if not (e["kernel"][0] <= 2 * e["textbook f32"][0]
                and e["kernel"][1] <= 2 * e["textbook f32"][1]):
            raise AssertionError(f"{n}^2 kernel-driven solve(200) is less "
                                 f"accurate than twice textbook f32 CG: {e}")

    # a smaller grid, where f32 stays within 1e-3 of float64 CG (numpy)
    small = build_system(SMALL_GRID, f32, device)
    hist50 = lt.CGSolver(small).solve(50).cpu().numpy()
    ref50, xref = classic_cg(np, (SMALL_GRID, SMALL_GRID), 50)
    dev50 = float(np.max(np.abs(hist50 - ref50) / ref50))
    xs = small.sol_vectors[0].to_numpy().reshape(SMALL_GRID, SMALL_GRID)
    xdev50 = float(np.max(np.abs(xs - xref)) / np.max(np.abs(xref)))
    if dev50 > 1e-3 or xdev50 > 1e-3:
        raise AssertionError(f"{SMALL_GRID}^2 solve(50) vs float64 CG: "
                             f"history {dev50:g}, x {xdev50:g}")
    log(f"[main] {SMALL_GRID}^2 solve(50) vs float64 CG: history max rel "
        f"{dev50:.3g}, x max rel {xdev50:.3g}")
    results = {"hist200_last": hist200[-1].item(),
               "kernel_vs_plain": (window, dev), "vs_f64_200": env,
               "vs_f64_200_other_sizes": env_n,
               "vs_f64_small": (dev50, xdev50), "residual_check": rel,
               "residual_check_textbook_f32": gap32}
    return counts, results, solver


def textbook_bicgstab(torch, shape, iters, dtype, device, dot_dtype=None,
                      matvec=lap5, rhs=None):
    """Textbook BiCGStab on ``matvec`` (default the 5-point Laplacian) over
    a grid of ``shape``, b = ``rhs`` (default 1), x0 = 0, r~ = b, in torch
    on ``device``; the dots summed in ``dot_dtype`` (default ``dtype``).
    Returns (history, x), both float64."""
    dd = dot_dtype or dtype
    dot = lambda a, b: torch.sum(a.to(dd) * b.to(dd)).to(dtype)
    b = (torch.ones(shape, dtype=dtype, device=device) if rhs is None
         else rhs.reshape(shape).to(dtype))
    x, r, rt = b * 0, b * 1, b * 1
    p, v = b * 0, b * 0
    rho, alpha, omega = (torch.tensor(c, dtype=dtype, device=device)
                         for c in (1.0, 0.0, 1.0))
    hist = [dot(r, r)]
    for _ in range(iters):
        rho_new = dot(r, rt)
        beta = (rho_new / rho) * (alpha / omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho / dot(rt, v)
        s = r - alpha * v
        t = matvec(s)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        hist.append(dot(r, r))
    return torch.stack(hist).double(), x.double()


def solution_quality(torch, hist, x, h64, x64, matvec=lap5, rhs=1.0):
    """(history max rel dev from float64, x max rel dev, true residual
    ||b - A x||^2 in float64, b = ``rhs``)."""
    x = x.double().reshape(x64.shape)
    return (((hist.double() - h64) / h64).abs().max().item(),
            ((x - x64).abs().max() / x64.abs().max()).item(),
            torch.sum((rhs - matvec(x)) ** 2).item())


def agree_window(hist, h64, rtol=1e-3):
    """Leading entries of ``hist`` within ``rtol`` of ``h64`` (a NaN
    disagrees)."""
    off = (~(((hist.double() - h64) / h64).abs() <= rtol)).nonzero()
    return int(off[0]) if len(off) else len(h64)


def snapshot(solver):
    planner = solver.planner
    vecs = {i: planner.get_vector(i, 0).data.clone()
            for i in (solver.SOL, solver.R, solver.P, solver.V)}
    return vecs, [s[-1] for s in (solver.rho, solver.alpha, solver.omega)]


def restore(solver, snap):
    vecs, (rho, alpha, omega) = snap
    for i, d in vecs.items():
        solver.planner.get_vector(i, 0).data = d.clone()
    solver.rho, solver.alpha, solver.omega = [rho], [alpha], [omega]


def bicgstab_path(torch, T, TB, lt, device):
    """Phase 4b, the BiCGStab path.  Returns (launch counts of the main-path
    run, results, the solver).  Everything is measured first and logged;
    the bounds are checked at the end."""
    from legionsolvers_tpu_torch.entry import build_system

    planner = build_system(N_GRID, lt.SolverOptions(entry_dtype=torch.float32),
                           device)
    op = planner.row_partitioned_matrices[0][0]
    if not op.supports_fused_bicgstab:
        raise AssertionError("the 4096^2 operator has no fused BiCGStab")
    solver = lt.BiCGStabSolver(planner)
    b = planner.rhs_vectors[0].data
    torch.cuda.synchronize()

    T.reset_launch_counts()
    eager = [solver.residual_norm_squared().value]
    for _ in range(N_EAGER):
        solver.step()
        eager.append(solver.residual_norm_squared().value)
    eager = torch.stack(eager)
    restart(solver)
    hist = solver.solve(N_ITERS)
    after = dict(T.LAUNCHES)
    x = planner.sol_vectors[0].data.clone()
    restart(solver)
    hist2 = solver.solve(N_ITERS)
    planner.matvec(solver.U, solver.SOL)  # K3 y: A x of the second solve
    torch.cuda.synchronize()
    counts = dict(T.LAUNCHES)
    T.reset_launch_counts()
    true_rr = torch.sum((b - planner.get_vector(solver.U, 0).data)
                        .double() ** 2).item()
    repeat = (torch.equal(hist, hist2)
              and torch.equal(x, planner.sol_vectors[0].data))
    rel = lambda a, c: ((a.double() - c.double()) / c.double()).abs()
    eager_dev = rel(eager, hist[:N_EAGER + 1])
    gap = abs(true_rr - hist[-1].item()) / hist[-1].item()
    log(f"[bicg] launches {counts}; repeat bit-identical {repeat}; eager vs "
        f"fused rel dev {[f'{e:.3g}' for e in eager_dev.tolist()]}; "
        f"||b-Ax||^2 {true_rr:.8g} vs history {hist[-1].item():.8g} "
        f"(rel {gap:.3g})")
    del hist2

    # compensated dots: kernel vs plain-driven, and one iteration continued
    # from the kernel path's own state along the whole trajectory
    comp = build_system(N_GRID, lt.SolverOptions(
        entry_dtype=torch.float32, compensated_dots=True), device)
    csolver = lt.BiCGStabSolver(comp)
    hist_ck = csolver.solve(N_ITERS)
    x_ck = comp.sol_vectors[0].data.clone()
    T.reset_launch_counts()
    with plain_driven(TB, csolver, bicg_plain(TB)):
        restart(csolver)
        hist_cp = csolver.solve(N_ITERS)
    x_cp = comp.sol_vectors[0].data.clone()
    if T.LAUNCHES:
        raise AssertionError("plain-driven solve launched kernels")
    comp_dev = rel(hist_ck, hist_cp)
    cont = []
    for k in CONTINUE_AT:
        restart(csolver)
        if k:
            csolver.solve(k)
        snap = snapshot(csolver)
        outs = []
        for plain in (False, True):
            restore(csolver, snap)
            if plain:
                with plain_driven(TB, csolver, bicg_plain(TB)):
                    h = csolver.solve(1)
            else:
                h = csolver.solve(1)
            outs.append((h[1], comp.sol_vectors[0].data.clone(),
                         comp.get_vector(csolver.R, 0).data.clone()))
        (hk, xk, rk), (hp, xp, rp) = outs
        vec = lambda a, c: ((a - c).abs().max() / c.abs().max()).item()
        cont.append((k, rel(hk, hp).item(), vec(xk, xp), vec(rk, rp)))
    log(f"[bicg] compensated, kernel vs plain-driven: first {N_AGREE + 4} "
        f"entries rel dev {[f'{e:.3g}' for e in comp_dev[:N_AGREE + 4]]}; "
        "one iteration from the kernel path's state at k (k, history, x, r): "
        + "; ".join(f"{k} {h:.3g} {xv:.3g} {rv:.3g}" for k, h, xv, rv in cont))

    # against float64 BiCGStab: 4096^2 plain dots (the main path) and 256^2
    # compensated (with plain f32 dots this 256^2 run breaks down: near the
    # f32 floor rho = <r~, r> is rounding noise and can sum to exactly 0)
    grid = (N_GRID, N_GRID)
    h64, x64 = textbook_bicgstab(torch, grid, N_ITERS, torch.float64, device)
    h32, x32 = textbook_bicgstab(torch, grid, N_ITERS, torch.float32, device)
    big = {"textbook f32": solution_quality(torch, h32, x32, h64, x64),
           "kernel": solution_quality(torch, hist, x, h64, x64),
           "kernel compensated": solution_quality(torch, hist_ck, x_ck,
                                                  h64, x64),
           "plain compensated": solution_quality(torch, hist_cp, x_cp,
                                                 h64, x64),
           "float64": solution_quality(torch, h64, x64, h64, x64)}
    win = (agree_window(h32, h64), agree_window(hist, h64))
    del h32, x32, x_cp
    small = build_system(SMALL_GRID, lt.SolverOptions(
        entry_dtype=torch.float32, compensated_dots=True), device)
    hs = lt.BiCGStabSolver(small).solve(N_ITERS)
    xs = small.sol_vectors[0].data
    sgrid = (SMALL_GRID, SMALL_GRID)
    s64, xs64 = textbook_bicgstab(torch, sgrid, N_ITERS, torch.float64,
                                  device)
    s32, xs32 = textbook_bicgstab(torch, sgrid, N_ITERS, torch.float32,
                                  device, dot_dtype=torch.float64)
    sm = {"textbook f32 (f64 dots)": solution_quality(torch, s32, xs32, s64,
                                                      xs64),
          "kernel compensated": solution_quality(torch, hs, xs, s64, xs64),
          "float64": solution_quality(torch, s64, xs64, s64, xs64)}
    swin = (agree_window(s32, s64), agree_window(hs, s64))
    fmt = lambda q: ", ".join(f"{k} {h:.3g} {xx:.3g} {res:.6g}"
                              for k, (h, xx, res) in q.items())
    log(f"[bicg] {N_GRID}^2 solve({N_ITERS}) against float64 BiCGStab "
        f"(history max rel, x max rel, ||b-Ax||^2): {fmt(big)}; entries "
        f"within 1e-3 of float64: textbook f32 {win[0]}, kernel {win[1]}")
    log(f"[bicg] {SMALL_GRID}^2 solve({N_ITERS}): {fmt(sm)}; entries within "
        f"1e-3 of float64: textbook f32 {swin[0]}, kernel {swin[1]}")

    # the bounds
    want = {"y": N_EAGER + 1, "y_dot": N_EAGER, "bicg_pv": 2 * N_ITERS,
            "bicg_st": 2 * N_ITERS, "bicg_update": 2 * N_ITERS}
    want_after = dict(want, y=N_EAGER, bicg_pv=N_ITERS, bicg_st=N_ITERS,
                      bicg_update=N_ITERS)
    if after != want_after or counts != want:
        raise AssertionError(f"BiCGStab launches {after}, then {counts}")
    if not repeat:
        raise AssertionError("two solves from the same state differ")
    for name, h in (("eager", eager), ("solve", hist),
                    ("compensated", hist_ck), ("256^2", hs)):
        if not bool(torch.isfinite(h).all()):
            raise AssertionError(f"BiCGStab {name} history is not finite")
    if not bool((b == 1.0).all()):
        raise AssertionError("the BiCGStab solve overwrote b")
    checks = {
        "eager step() vs fused solve, first entries, rtol 1e-6":
            eager_dev[:N_AGREE].max().item() <= 1e-6,
        "compensated kernel vs plain-driven, first entries, rtol 1e-6":
            comp_dev[:N_AGREE].max().item() <= 1e-6,
        "one iteration from the kernel path's states, kernel vs plain, 1e-2":
            max(max(c[1:]) for c in cont) <= 1e-2,
        "||b - Ax||^2 vs history[-1], rel 5e-2": gap <= 5e-2,
        f"{N_GRID}^2 kernel within 1e-3 of float64 while textbook f32 is":
            win[1] >= win[0],
        f"{N_GRID}^2 ||b-Ax||^2 and x error <= 2x textbook f32":
            big["kernel"][2] <= 2 * big["textbook f32"][2]
            and big["kernel"][1] <= 2 * big["textbook f32"][1],
        f"{SMALL_GRID}^2 kernel within 1e-3 of float64 while textbook is":
            swin[1] >= swin[0],
        f"{SMALL_GRID}^2 ||b-Ax||^2 and x error <= 2x textbook f32":
            sm["kernel compensated"][2]
            <= 2 * sm["textbook f32 (f64 dots)"][2]
            and sm["kernel compensated"][1]
            <= 2 * sm["textbook f32 (f64 dots)"][1],
    }
    failed = [k for k, ok in checks.items() if not ok]
    log(f"[bicg] checks: {len(checks) - len(failed)} of {len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    results = {"hist_last": hist[-1].item(), "true_rr": true_rr,
               "residual_gap": gap, "eager_dev": eager_dev.tolist(),
               "comp_kernel_vs_plain": comp_dev[:N_AGREE + 4].tolist(),
               "continuation": cont, "vs_f64": big, "window": win,
               "vs_f64_small": sm, "window_small": swin, "checks": checks}
    return counts, results, solver, failed


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

EVENT_WINDOWS = []  # the last event_ms call's mean ms in each third


def event_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after warm-up.
    An event at each third of the calls leaves the mean of each third in
    EVENT_WINDOWS, so that a stall of the host shows as one slow third."""
    fn()
    torch.cuda.synchronize()
    cuts = sorted({0, reps // 3, 2 * reps // 3, reps})
    events = [torch.cuda.Event(enable_timing=True) for _ in cuts]
    events[0].record()
    for i in range(1, len(cuts)):
        for _ in range(cuts[i] - cuts[i - 1]):
            fn()
        events[i].record()
    events[-1].synchronize()
    EVENT_WINDOWS[:] = [events[i - 1].elapsed_time(events[i])
                        / (cuts[i] - cuts[i - 1]) for i in range(1, len(cuts))]
    return events[0].elapsed_time(events[-1]) / reps


def graph_ms(torch, fns, reps):
    """Mean device ms of one call, ``reps`` calls cycling through ``fns``
    captured in one CUDA graph and replayed between two CUDA events: the
    device time alone, for kernels shorter than the host's enqueue of
    them."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copy_bandwidth(torch, device):
    """Bytes/s of a device-to-device copy of 1 GiB (read + write)."""
    src = torch.empty(2**28, dtype=torch.float32, device=device).fill_(1.0)
    dst = torch.empty_like(src)
    ms = event_ms(torch, lambda: dst.copy_(src), 20)
    return 2 * src.numel() * 4 / (ms * 1e-3)


def sane(label, ms, nbytes, bw):
    """Refuse a time that moves ``nbytes`` faster than the measured copy."""
    floor = nbytes / bw * 1e3
    if not ms >= floor:
        raise AssertionError(
            f"{label}: {ms:.4f} ms is under the {floor:.4f} ms that "
            f"{nbytes} bytes take at the measured copy bandwidth")
    return ms


# launches of K3's modes and K4 per solve(200) of the paths that run them
# (GMRES(10): one residual and ten Arnoldi matvecs per cycle, 20 cycles)
PATH_LAUNCHES_2D = {"two-pass CG": {"pq": 1, "update": N_ITERS,
                                    "xpay_pq": N_ITERS - 1},
                    "PCG": {"y_dot": N_ITERS},
                    "GMRES(10)": {"y": 11 * N_ITERS // 10}}


def time_kernels(torch, T, device, bw, card):
    """Phase 5a.  {mode: (kernel ms, plain ms, kernel ms in CUDA graphs)}
    at the main-path shape; a ring of three input sets (3 x 64 MB per
    vector) keeps the 50 MB L2 from serving repeated launches.  The graph
    time is the device's alone: the shortest passes take less time on the
    card than their wrappers' host work, which the events see."""
    n = N_GRID * N_GRID
    out = {}
    for mode, (_, _, bpe) in KERNELS.items():
        ring = [make_inputs(torch, T, (N_GRID, N_GRID), s, device)
                for s in range(3)]
        times = {}
        for plain in (False, True):
            fns = [kernel_call(T, mode, d, plain) for d in ring]
            k = iter(range(10**9))
            times[plain] = event_ms(
                torch, lambda: fns[next(k) % 3](), 6 if plain else 30)
            if not plain:
                thirds = list(EVENT_WINDOWS)
        graph = graph_ms(torch, [kernel_call(T, mode, d, False)
                                 for d in ring], 30)
        sane(mode, times[False], bpe * n, bw)
        sane(f"{mode} (graphs)", graph, bpe * n, bw)
        out[mode] = (times[False], times[True], graph)
        log(f"[time] {mode:8s} kernel {times[False]:.4f} ms "
            f"({bpe * n / times[False] / 1e6:.1f} GB/s; by thirds "
            f"{', '.join(f'{t:.4f}' for t in thirds)}; CUDA graphs "
            f"{graph:.4f}), plain {times[True]:.4f} ms at {N_GRID}^2 f32 "
            f"on {card}")
        del ring
    return out


def kernel_call(T, mode, d, plain, kw=KW):
    """A closure running one pass on ``d`` in place (no copies), so that
    the timing sees the pass alone.  The in-place passes (update, step2)
    keep their inputs bounded: update with a tiny alpha, step2 writing
    back into its own output pair."""
    if mode in ("y", "y_dot"):
        if plain:
            return lambda: T.stencil_plain(mode, d["x"], None, None, **kw)
        return lambda: T.grid2d_stencil_matvec(d["x"], with_dot=mode == "y_dot",
                                               **kw)
    if mode == "pq":
        if plain:
            return lambda: T.stencil_plain("pq", d["p"], None, None, **kw)
        return lambda: T.grid2d_cg_pq(d["p"], **kw)
    if mode == "update":
        a = d["alpha"] * 1e-6
        if plain:
            return lambda: T.stencil_plain("update", d["p"], None, None,
                                           (d["x"], d["r"], a), **kw)
        return lambda: T.grid2d_cg_update(d["p"], d["x"], d["r"], a, **kw)
    if mode == "xpay_pq":
        out = d["x"]
        fn = T.xpay_pq_plain if plain else T.grid2d_cg_xpay_pq
        return lambda: fn(d["r"], d["p"], d["beta"], out=out, **kw)
    if mode == "gram2":
        fn = T.gram2_plain if plain else T.grid2d_cg_gram2
        return lambda: fn(d["r"], d["p"], **kw)
    spare = (d["rt"].new_empty(d["r"].shape), d["pt"].new_empty(d["p"].shape))
    fn = T.step2_plain if plain else T.grid2d_cg_step2
    return lambda: fn(d["x"], d["r"], d["p"], d["coef"], out=spare, **kw)


def time_solve(torch, T, solver, bw, card):
    """Phase 5b.  ms/iter of solve(200) at 4096^2, kernel- and
    plain-driven (:func:`solve_ms`)."""
    n = N_GRID * N_GRID
    # 12 B/unknown/iteration for the s-step passes + 7 gram2 passes of 8 B
    nbytes = (24 * 100 + 8 * 7) * n
    res = {}
    for label in ("kernel", "plain"):
        ctx = (plain_driven(T, solver, cg_plain(T)) if label == "plain"
               else None)
        ms, host_ms = solve_ms(torch, solver, 200, ctx)
        sane(f"solve(200) {label}", ms, nbytes, bw)
        res[label] = ms / 200
        res[f"{label} host enqueue"] = host_ms / 200
        log(f"[time] solve(200) {label}-driven: {ms / 200:.4f} ms/iter "
            f"({nbytes / 200 / (ms / 200) / 1e6:.1f} GB/s effective, "
            f"{(5 * n - 4 * N_GRID) / (ms / 200 * 1e-3) / 1e9:.2f} Gnnz/s; "
            f"host enqueue {host_ms / 200:.4f} ms/iter) at {N_GRID}^2 f32 on "
            f"{card}")
    return res


def time_bicg_kernels(torch, TB, device, bw, card):
    """Phase 5c.  {name: {compensated: (kernel ms, plain ms)}} at the main
    path shape, over a ring of three input sets as in phase 5a."""
    n = N_GRID * N_GRID
    out = {name: {} for name in BICG_KERNELS}
    ring = [bicg_inputs(torch, (N_GRID, N_GRID), 40 + s, device)
            for s in range(3)]
    for d in ring:
        d["alpha"] = d["alpha"] * 1e-3  # keep the in-place x bounded
        d["p_out"], d["v_out"], d["r_out"] = (torch.empty_like(d["r"])
                                              for _ in range(3))
    for name, (_, bpe) in BICG_KERNELS.items():
        for comp in (False, True):
            times = {}
            for plain in (False, True):
                fns = [bicg_call(TB, name, d, comp, plain,
                                 out=(d["p_out"], d["v_out"])
                                 if name == "bicg_pv" else d["r_out"])
                       for d in ring]
                k = iter(range(10**9))
                times[plain] = event_ms(
                    torch, lambda: fns[next(k) % 3](), 6 if plain else 30)
            sane(name, times[False], bpe * n, bw)
            out[name][comp] = (times[False], times[True])
            log(f"[time] {name:11s} compensated={comp!s:5s} kernel "
                f"{times[False]:.4f} ms ({bpe * n / times[False] / 1e6:.1f} "
                f"GB/s), plain {times[True]:.4f} ms at {N_GRID}^2 f32 on "
                f"{card}")
    return out


def time_bicg_solve(torch, TB, solver, bw, card):
    """Phase 5d.  ms/iter of BiCGStab solve(200) at 4096^2, kernel- and
    plain-driven, as in phase 5b."""
    n = N_GRID * N_GRID
    # 60 B/unknown/iteration + the two bootstrap dots (8 B each)
    nbytes = (60 * N_ITERS + 16) * n
    res = {}
    for label in ("kernel", "plain"):
        ctx = (plain_driven(TB, solver, bicg_plain(TB)) if label == "plain"
               else None)
        ms, host_ms = solve_ms(torch, solver, N_ITERS, ctx)
        sane(f"BiCGStab solve({N_ITERS}) {label}", ms, nbytes, bw)
        res[label] = ms / N_ITERS
        log(f"[time] BiCGStab solve({N_ITERS}) {label}-driven: "
            f"{ms / N_ITERS:.4f} ms/iter ({nbytes / ms / 1e6:.1f} GB/s "
            f"effective; host enqueue {host_ms / N_ITERS:.4f} ms/iter) at "
            f"{N_GRID}^2 f32 on {card}")
    return res


def profile_solve(torch, solver, label, card, wall_ms=None, n_iters=N_ITERS):
    """With --profile: device time by kernel over one solve(n_iters), from
    a torch.profiler trace, written to profile_<label>.txt in the output
    directory; returns the device ms.  Runs last, because the tracer slows the host's
    later launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    restart(solver)
    solver.solve(n_iters)
    restart(solver)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.solve(n_iters)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    path = pathlib.Path("chiprun_out") / f"profile_{label}.txt"
    path.parent.mkdir(exist_ok=True)
    path.write_text(f"{card}\n{table}\n")
    log(table)
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    idle = ("" if wall_ms is None else
            f"; idle {100 * (1 - device_ms / wall_ms):.1f}% of the unprofiled "
            f"{wall_ms:.3f} ms")
    log(f"[profile] {label} solve({n_iters}): device time {device_ms:.3f} "
        f"ms in all kernels and copies{idle}, on {card}")
    return device_ms


# ---------------------------------------------------------------------------
# 3-D: phase 3c (K6, K7 against their plain versions), 4c (CG), 4d
# (BiCGStab), 5e (timing)
# ---------------------------------------------------------------------------

def stencil_kw(lt, dim):
    """offsets= and values= of the -dim 3 (7-point) or 4 (27-point)
    stencil, or of REACH2."""
    if dim == REACH2:
        return REACH2_KW
    st = lt.laplacian_stencil(dim)
    return dict(offsets=tuple(o for o, _ in st),
                values=tuple(v for _, v in st))


def stencil_matvec(torch, lt, dim):
    """y = A v for the -dim ``dim`` stencil (:func:`terms_matvec`)."""
    return terms_matvec(torch, lt.laplacian_stencil(dim))


def inputs3d(torch, shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    d = {k: torch.randn(shape, generator=g, device=device)
         for k in ("x", "r", "p", "v", "rt")}
    for k in ("top", "bot"):
        d[k] = torch.randn(shape[1:], generator=g, device=device)
    for k, val in (("alpha", 0.83), ("beta", 0.37), ("omega", 0.41)):
        d[k] = torch.tensor(val, device=device)
    return d


def call3d(T3, TB3, name, d, kw, plain, compensated=False, out=None):
    """A closure running one 3-D pass on ``d`` (x and r of update3d, x of
    bicg3d_update in place) with the halo planes d["top"], d["bot"]: the
    wrapper or its plain version.  Results as tuples named by NAMES3."""
    h = (d["top"], d["bot"])
    if name in ("y3d", "y_dot3d", "pq3d", "update3d"):
        mode = name[:-2]
        src = d["p"] if mode in ("pq", "update") else d["x"]
        extra = (d["x"], d["r"], d["alpha"]) if mode == "update" else ()
        if plain:
            return lambda: T3.stencil3d_plain(mode, src, *h, extra, **kw)
        if mode == "update":
            return lambda: T3.grid3d_cg_update(src, *extra, *h, **kw)
        if mode == "pq":
            return lambda: (T3.grid3d_cg_pq(src, *h, **kw),)
        if mode == "y":
            return lambda: (T3.grid3d_stencil_matvec(src, *h, **kw),)
        return lambda: T3.grid3d_stencil_matvec(src, *h, with_dot=True, **kw)
    if name == "xpay_pq3d":
        fn = T3.xpay_pq3d_plain if plain else T3.grid3d_cg_xpay_pq
        return lambda: fn(d["r"], d["p"], d["beta"], *h, out=out, **kw)
    fn = getattr(TB3, name + "_plain" if plain else name)
    kw = dict(kw, compensated=compensated)
    if name == "bicg3d_pv":
        return lambda: fn(d["r"], d["p"], d["v"], d["rt"], d["beta"],
                          d["omega"], *h, out=out, **kw)
    if name == "bicg3d_st":
        return lambda: fn(d["r"], d["v"], d["alpha"], *h, **kw)
    return lambda: fn(d["r"], d["v"], d["x"], d["p"], d["rt"], d["alpha"],
                      d["omega"], *h, out=out, **kw)


def dot_operands3(T3, name, d, outs, kw):
    """The f32 operand pair of each dot a 3-D pass returns, from ``outs``
    where the pass writes it and from the plain stencil otherwise."""
    A = lambda v: T3.apply_planes_plain(v, kw["offsets"], kw["values"],
                                        d["top"], d["bot"])
    if name == "y_dot3d":
        return {"dot": (d["x"], outs["y"])}
    if name == "pq3d":
        return {"dot": (d["p"], A(d["p"]))}
    if name == "update3d":
        return {"dot": (outs["r"], outs["r"])}
    if name == "xpay_pq3d":
        return {"dot": (outs["p"], A(outs["p"]))}
    if name == "bicg3d_pv":
        return {"rtv": (d["rt"], outs["v"])}
    if name == "bicg3d_update":
        return {"rr": (outs["r"], outs["r"]), "rtr": (d["rt"], outs["r"])}
    s = d["r"] - d["alpha"] * d["v"]
    t = A(s)
    return {"ts": (t, s), "tt": (t, t)}


def compare_3d_kernels(torch, lt, T3, TB3, device):
    """Phase 3c: K6a (four modes), K6b and K7 (compensated dots off and on)
    against their plain versions, 7- and 27-point stencils (march1, but
    march3d for K7 update with compensated dots) and REACH2 (the window
    march), at 256^3 and a ragged 37 x 45 x 130, with random halo planes.
    The bounds of phases 3 and 3b.  Returns {(name, dim): max abs
    error}."""
    f64dot = lambda a, b: torch.dot(a.double().reshape(-1),
                                    b.double().reshape(-1)).item()
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = {}
    for shape in (SHAPE3, RAGGED3):
        d = inputs3d(torch, shape, 29, device)
        for dim in (*DIMS3, REACH2):
            kw = stencil_kw(lt, dim)
            for name in (*KERNELS3, *BICG3_KERNELS):
                for comp in ((False, True) if name in BICG3_KERNELS
                             else (False,)):
                    outs = {}
                    for plain in (False, True):
                        c = {k: v.clone() for k, v in d.items()}
                        res = call3d(T3, TB3, name, c, kw, plain, comp)()
                        outs[plain] = dict(zip(NAMES3[name], res))
                    got, ref = outs[False], outs[True]
                    torch.cuda.synchronize()
                    ops = dot_operands3(T3, name, d, ref, kw)
                    worst = 0.0
                    for key, want in ref.items():
                        err = (got[key].double() - want.double()).abs().max()
                        worst = max(worst, err.item())
                        if want.dim():
                            ok = err.item() <= 1e-5 * want.abs().max().item()
                        else:
                            a, b = ops[key]
                            ok = err.item() <= 1e-4 * nrm(a) * nrm(b)
                        if not ok:
                            raise AssertionError(
                                f"{name} {shape} dim {dim} compensated="
                                f"{comp} {key}: kernel disagrees with its "
                                f"plain version (max abs err {err.item():g})")
                    exact_rel = 0.0
                    if comp:
                        for key, (a, b) in dot_operands3(
                                T3, name, d, got, kw).items():
                            exact = f64dot(a, b)
                            rel = abs(got[key].item() - exact) / abs(exact)
                            exact_rel = max(exact_rel, rel)
                            if rel > 4e-7:
                                raise AssertionError(
                                    f"{name} {shape} dim {dim} {key}: "
                                    f"compensated dot {rel:g} off the "
                                    "float64 sum")
                    errs[name, dim] = max(errs.get((name, dim), 0.0), worst)
                    log(f"[check3d] {name:13s} {shape} dim {dim}"
                        + (f" compensated={comp}" if name in BICG3_KERNELS
                           else "")
                        + f": kernel == plain (max abs err {worst:.3g}"
                        + (f"; dots vs float64 sum max rel {exact_rel:.3g})"
                           if comp else ")"))
        del d
    return errs


TRACE_TAKES = 4  # traces of a batch before device_kernels gives up


def device_kernels(torch, fns):
    """For each call in ``fns``, the names of the CUDA kernels it
    launches, from one torch.profiler trace of them all: the calls run in
    order on one stream, each followed by torch's spin kernel, and the
    device kernels, in start order, are split at the spin kernels.  One
    trace per batch, not per call: a trace has at times come back with
    no device event at all, or with the spin kernel alone, and four
    traces in a row of one call once did, after some fifty traces in one
    process.  A trace whose spin kernels do not number one per call, or
    in which a call launched nothing (every call traced here launches a
    kernel), lost device events, so it is taken again, at most
    TRACE_TAKES times, and never read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:  # a first call makes the wrappers' scratch
        fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TAKES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        calls, names = [], set()
        for _, name in kernels:
            if "spin_kernel" in name:
                calls.append(sorted(names))
                names = set()
            else:
                names.add(name)
        if len(calls) == len(fns) and not names and all(calls):
            return calls
        log(f"[check] a trace of {len(fns)} calls lost device events (saw "
            f"{len(calls)} spin kernels); taking it again")
    raise AssertionError(f"{TRACE_TAKES} traces of {len(fns)} calls lost "
                         "their device events")


def check_one_launch_3d(torch, lt, T3, TB3, device):
    """Phase 3c: every 3-D pass with the 7- and 27-point stencils and
    REACH2 (compensated dots off and on for K7) launches what
    ``T3.route3d`` says its march launches: one kernel of march1
    (``m1_kernel``) or of the window march (``win_kernel``: every pass on
    REACH2) and no reduce_partials, or march3d's kernel and its second
    launch (K7 update with compensated dots on the 7- and 27-point
    stencils), which shows that the trace sees a second launch.  Returns
    {case: kernel names}."""
    d = inputs3d(torch, RAGGED3, 31, device)
    seen, bad, calls = {}, [], {}
    for dim in (*DIMS3, REACH2):
        kw = stencil_kw(lt, dim)
        for name in (*KERNELS3, *BICG3_KERNELS):
            for comp in ((False, True) if name in BICG3_KERNELS
                         else (False,)):
                c = {k: v.clone() for k, v in d.items()}
                calls[name, dim, comp] = call3d(T3, TB3, name, c, kw, False,
                                                comp)
    for (name, dim, comp), names in zip(
            calls, device_kernels(torch, list(calls.values()))):
        case = f"{name} dim {dim} compensated={comp}"
        seen[case] = names
        second = any("reduce_partials" in n for n in names)
        route = T3.route3d(name, stencil_kw(lt, dim)["offsets"], comp)
        if route == "march3d":
            ok = second
        else:
            kernel = "m1_kernel" if route == "march1" else "win_kernel"
            ok = len(names) == 1 and kernel in names[0] and not second
        if not ok:
            bad.append((case, route, names))
    log(f"[check3d] one launch per march1 and window-march pass, two per "
        f"march3d pass: " + ("yes" if not bad else f"NO: {bad}") + "; e.g. "
        + "; ".join(f"{k}: {seen[k]}" for k in (
            "xpay_pq3d dim 4 compensated=False",
            f"update3d dim {REACH2} compensated=False",
            f"bicg3d_pv dim {REACH2} compensated=True",
            "bicg3d_st dim 3 compensated=True",
            f"bicg3d_st dim {REACH2} compensated=False",
            "bicg3d_update dim 3 compensated=False",
            "bicg3d_update dim 3 compensated=True")))
    if bad:
        raise AssertionError(f"3-D passes whose launches are not their "
                             f"march's: {bad}")
    return seen


def march1_attrs(lib):
    """{kernel variant: [registers, spill bytes, resident blocks per SM]}
    of every march1 kernel (cudaFuncGetAttributes and the occupancy
    calculator on this card)."""
    import ctypes

    out, res = (ctypes.c_int * 3)(), {}
    for fn, n, names in (
            ("ls_stencil3d_m1_attrs", 16,
             ("y", "y_dot", "pq", "update")),
            ("ls_xpay_pq3d_m1_attrs", 4, ("xpay_pq",)),
            ("ls_bicg3d_pv_m1_attrs", 8, ("pv", "pv compensated")),
            ("ls_bicg3d_st_m1_attrs", 8, ("st", "st compensated")),
            ("ls_bicg3d_update_m1_attrs", 4, ("bicg_update",))):
        for which in range(n):
            err = getattr(lib, fn)(which, out)
            if err:
                raise RuntimeError(f"{fn}({which}): CUDA error {err}")
            label = (f"{names[which // 4]} "
                     f"{'star' if which & 2 else 'box'} "
                     f"{'vec' if which & 1 else 'scalar'}")
            res[label] = list(out)
    return res


def cg3d_plain(T3):
    """The plain versions of the 3-D CG runner's wrappers."""
    return {
        "grid3d_cg_pq": lambda p, top=None, bot=None, **kw:
            T3.stencil3d_plain("pq", p, top, bot, **kw)[0],
        "grid3d_cg_update": lambda p, x, r, alpha, top=None, bot=None, **kw:
            T3.stencil3d_plain("update", p, top, bot, (x, r, alpha), **kw),
        "grid3d_cg_xpay_pq": T3.xpay_pq3d_plain,
    }


def bicg3d_plain(TB3):
    return {k: getattr(TB3, k + "_plain") for k in BICG3_KERNELS}


def rel_dev(a, b):
    return ((a.double() - b.double()) / b.double()).abs()


def max_rel(a, b):
    return rel_dev(a, b).max().item()


def same_bits(a, b):
    """Bit-identical, NaNs included (torch.equal calls NaN != NaN)."""
    import torch

    as_int = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and torch.equal(a.view(as_int), b.view(as_int))


def eager_ok(dev):
    """Eager step()s vs the fused solve: the first two history entries to
    EAGER3_RTOL[0], the rest to EAGER3_RTOL[1]."""
    return (dev[:2].max().item() <= EAGER3_RTOL[0]
            and dev.max().item() <= EAGER3_RTOL[1])


def x_rel(x, x64):
    x = x.double().reshape(x64.shape)
    return ((x - x64).abs().max() / x64.abs().max()).item()


def cg3d_path(torch, T, lt, device, dim):
    """Phase 4c: ``build_stencil_system(dim, 256^3)`` -> ``CGSolver``: eager
    ``step()``s (K6a y_dot), ``solve(200)`` (1 pq + 200 update + 199
    xpay_pq, counted exactly), the same solve again (bit-identical history
    and x), ||b - Ax||^2 through ``planner.matvec`` (K6a y) against the
    last history entry, and the solve against float64 CG.  Returns (launch
    counts of the run, results, solver, failed checks)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    planner = build_stencil_system(
        dim, SHAPE3, lt.SolverOptions(entry_dtype=torch.float32), device)
    op = planner.row_partitioned_matrices[0][0]
    if not (op.uses_pallas and op._view["kind"] == "3d"):
        raise AssertionError(f"-dim {dim} 256^3 is not on the 3-D view")
    solver = lt.CGSolver(planner)
    b = planner.rhs_vectors[0].data
    torch.cuda.synchronize()

    T.reset_launch_counts()
    for _ in range(N_EAGER):
        solver.step()
    eager = torch.stack([s.value for s in solver.residual_norm_squared])
    restart(solver)
    hist = solver.solve(N_ITERS)
    after = dict(T.LAUNCHES)
    x = planner.sol_vectors[0].data.clone()
    restart(solver)
    hist2 = solver.solve(N_ITERS)
    planner.matvec(solver.Q, solver.SOL)
    torch.cuda.synchronize()
    counts = dict(T.LAUNCHES)
    T.reset_launch_counts()
    repeat = same_bits(hist, hist2) and same_bits(
        x, planner.sol_vectors[0].data)
    true_rr = torch.sum((b - planner.get_vector(solver.Q, 0).data)
                        .double() ** 2).item()
    gap = abs(true_rr - hist[-1].item()) / hist[-1].item()
    eager_dev = rel_dev(eager, hist[:N_EAGER + 1])

    A = stencil_matvec(torch, lt, dim)
    h64, x64 = classic_cg(torch, SHAPE3, N_ITERS, torch.float64, device, A)
    h32, x32 = classic_cg(torch, SHAPE3, N_ITERS, torch.float32, device, A)
    gap32 = abs(torch.sum((1.0 - A(x32)) ** 2).item() - h32[-1].item()) \
        / h32[-1].item()
    env = {"textbook f32": (max_rel(h32, h64), x_rel(x32, x64)),
           "kernel": (max_rel(hist, h64), x_rel(x, x64))}
    text_dev = rel_dev(h32, h64)[:N_EAGER + 1]
    log(f"[cg3d] dim {dim}: launches {after}, then {counts}; repeat "
        f"bit-identical {repeat}; eager vs fused rel dev "
        f"{[f'{e:.3g}' for e in eager_dev.tolist()]}; textbook f32 vs "
        f"float64 rel dev {[f'{e:.3g}' for e in text_dev.tolist()]}; "
        f"residual^2 {hist[0].item():.6g} -> {hist[-1].item():.6g} (float64 "
        f"CG {h64[-1].item():.6g}); ||b-Ax||^2 {true_rr:.6g} (rel gap "
        f"{gap:.3g}; textbook f32 {gap32:.3g}); against float64 CG "
        "(history, x max rel): " + ", ".join(
            f"{k} {h:.3g} {xx:.3g}" for k, (h, xx) in env.items()))

    want_after = dict(SOLVE3_LAUNCHES["cg"], y_dot3d=N_EAGER)
    want = {k: 2 * v for k, v in want_after.items()}
    want.update(y_dot3d=N_EAGER, y3d=1)
    k_env, t_env = env["kernel"], env["textbook f32"]
    checks = {
        "launches": after == want_after and counts == want,
        "two solves from one state are bit-identical": repeat,
        "histories finite": bool(torch.isfinite(hist).all()
                                 and torch.isfinite(eager).all()),
        "b intact": bool((b == 1.0).all()),
        f"eager step() vs fused solve, rtol {EAGER3_RTOL}": eager_ok(eager_dev),
        "||b - Ax||^2 vs history[-1] within twice textbook f32's gap (or "
        f"{CG3_GAP_FLOOR})": gap <= max(2 * gap32, CG3_GAP_FLOOR),
        "history and x within twice textbook f32 CG's distance from "
        f"float64 CG (floor {CG3_F64_FLOOR})":
            k_env[0] <= max(2 * t_env[0], CG3_F64_FLOOR)
            and k_env[1] <= max(2 * t_env[1], CG3_F64_FLOOR),
    }
    failed = [f"cg3d dim {dim}: {k}" for k, ok in checks.items() if not ok]
    results = {"hist_first_last": (hist[0].item(), hist[-1].item()),
               "true_rr": true_rr, "gap": gap, "gap_textbook": gap32,
               "eager_dev": eager_dev.tolist(), "vs_f64": env,
               "checks": checks}
    return counts, results, solver, failed


def bicg3d_path(torch, T, lt, device, dim):
    """Phase 4d: the same system -> ``BiCGStabSolver``: eager ``step()``s
    (K6a y, y_dot), ``solve(200)`` (200 of each K7 pass, counted exactly),
    the same solve again (bit-identical, NaNs included), ``solve(20)`` and
    ||b - Ax||^2 through ``planner.matvec`` (K6a y) against its last
    history entry.  Against float64 BiCGStab: the f32-dot solve stays
    within 1e-3 as long as textbook f32 does; f32 BiCGStab breaks down on
    the 7-point system (textbook f32 too), so the end result is held with
    compensated dots, as phase 4b does at 256^2, against textbook f32 with
    float64 dots.  Returns (launch counts of the run, results, solver,
    failed checks)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    planner = build_stencil_system(
        dim, SHAPE3, lt.SolverOptions(entry_dtype=torch.float32), device)
    op = planner.row_partitioned_matrices[0][0]
    if not op.supports_fused_bicgstab:
        raise AssertionError(f"-dim {dim} 256^3 has no fused BiCGStab")
    solver = lt.BiCGStabSolver(planner)
    b = planner.rhs_vectors[0].data
    torch.cuda.synchronize()

    T.reset_launch_counts()
    eager = [solver.residual_norm_squared().value]
    for _ in range(N_EAGER):
        solver.step()
        eager.append(solver.residual_norm_squared().value)
    eager = torch.stack(eager)
    restart(solver)
    hist = solver.solve(N_ITERS)
    after = dict(T.LAUNCHES)
    x = planner.sol_vectors[0].data.clone()
    restart(solver)
    hist2 = solver.solve(N_ITERS)
    repeat = same_bits(hist, hist2) and same_bits(
        x, planner.sol_vectors[0].data)
    restart(solver)
    h_gap = solver.solve(GAP_ITERS)
    planner.matvec(solver.U, solver.SOL)
    torch.cuda.synchronize()
    counts = dict(T.LAUNCHES)
    T.reset_launch_counts()
    true_rr = torch.sum((b - planner.get_vector(solver.U, 0).data)
                        .double() ** 2).item()
    gap = abs(true_rr - h_gap[-1].item()) / h_gap[-1].item()
    eager_dev = rel_dev(eager, hist[:N_EAGER + 1])

    comp = build_stencil_system(dim, SHAPE3, lt.SolverOptions(
        entry_dtype=torch.float32, compensated_dots=True), device)
    hist_c = lt.BiCGStabSolver(comp).solve(N_ITERS)
    x_c = comp.sol_vectors[0].data
    T.reset_launch_counts()

    A = stencil_matvec(torch, lt, dim)
    h64, x64 = textbook_bicgstab(torch, SHAPE3, N_ITERS, torch.float64,
                                 device, matvec=A)
    h32, x32 = textbook_bicgstab(torch, SHAPE3, N_ITERS, torch.float32,
                                 device, matvec=A)
    hd, xd = textbook_bicgstab(torch, SHAPE3, N_ITERS, torch.float32, device,
                               dot_dtype=torch.float64, matvec=A)
    finite = lambda h: bool(torch.isfinite(h).all())
    first_bad = lambda h: (None if finite(h)
                           else int((~torch.isfinite(h)).nonzero()[0]))
    q = {"textbook f32 (f64 dots)": solution_quality(torch, hd, xd, h64, x64,
                                                     A),
         "kernel compensated": solution_quality(torch, hist_c, x_c, h64, x64,
                                                A),
         "float64": solution_quality(torch, h64, x64, h64, x64, A)}
    win = (agree_window(h32, h64), agree_window(hist, h64),
           agree_window(hd, h64), agree_window(hist_c, h64))
    breakdown = (first_bad(h32), first_bad(hist))
    log(f"[bicg3d] dim {dim}: launches {after}, then {counts}; repeat "
        f"bit-identical {repeat}; eager vs fused rel dev "
        f"{[f'{e:.3g}' for e in eager_dev.tolist()]}; f32 dots: residual^2 "
        f"{hist[0].item():.6g} -> {hist[-1].item():.6g} (float64 "
        f"{h64[-1].item():.6g}), first non-finite entry: textbook f32 "
        f"{breakdown[0]}, kernel {breakdown[1]}; after {GAP_ITERS}: "
        f"||b-Ax||^2 {true_rr:.8g} vs history {h_gap[-1].item():.8g} (rel "
        f"{gap:.3g}); compensated, against float64 BiCGStab (history max "
        "rel, x max rel, ||b-Ax||^2): " + ", ".join(
            f"{k} {h:.3g} {xx:.3g} {res:.6g}" for k, (h, xx, res) in q.items())
        + "; entries within 1e-3 of float64 (textbook f32, kernel; with "
        f"f64 dots: textbook, kernel compensated): {win}")

    want_after = {"y3d": N_EAGER, "y_dot3d": N_EAGER, "bicg3d_pv": N_ITERS,
                  "bicg3d_st": N_ITERS, "bicg3d_update": N_ITERS}
    n_pass = 2 * N_ITERS + GAP_ITERS
    want = dict(want_after, y3d=N_EAGER + 1, bicg3d_pv=n_pass,
                bicg3d_st=n_pass, bicg3d_update=n_pass)
    kq, tq = q["kernel compensated"], q["textbook f32 (f64 dots)"]
    checks = {
        "launches": after == want_after and counts == want,
        "two solves from one state are bit-identical": repeat,
        "eager and compensated histories finite":
            finite(eager) and finite(hist_c),
        "b intact": bool((b == 1.0).all()),
        f"eager step() vs fused solve, rtol {EAGER3_RTOL}": eager_ok(eager_dev),
        f"||b - Ax||^2 vs history after {GAP_ITERS}, rel {BICG3_GAP}":
            gap <= BICG3_GAP,
        "f32 dots: kernel within 1e-3 of float64 as long as textbook f32 is":
            win[1] >= win[0],
        "compensated: kernel within 1e-3 of float64 as long as textbook "
        "f32 with f64 dots is": win[3] >= win[2],
        "compensated: ||b-Ax||^2 <= 2x textbook f32's, x error <= 2x "
        f"textbook f32's (or {BICG3_X_FLOOR})":
            kq[2] <= 2 * tq[2] and kq[1] <= max(2 * tq[1], BICG3_X_FLOOR),
    }
    failed = [f"bicg3d dim {dim}: {k}" for k, ok in checks.items() if not ok]
    results = {"hist_first_last": (hist[0].item(), hist[-1].item()),
               "breakdown": breakdown, "true_rr": true_rr, "gap": gap,
               "eager_dev": eager_dev.tolist(), "vs_f64": q, "window": win,
               "checks": checks}
    return counts, results, solver, failed


def time_3d_kernels(torch, lt, T3, TB3, device, bw, card):
    """Phase 5e.  {(name, dim, compensated): (kernel ms, plain ms)} at
    256^3 over a ring of three input sets (3 x 67 MB per vector against
    the 50 MB L2), without halo planes, as the main path calls them, each
    logged with its bound, its launches per solve(200) (SOLVE3_LAUNCHES)
    and the ms it loses per solve(200), launches x (time - bound); {dim:
    ms} of F.conv3d computing K6a's y on the same inputs (cuDNN, TF32
    off), held to the kernel's y; and {(name, dim, compensated): ms} of
    the kernels in CUDA graphs (:func:`graph_ms`: device time alone, for
    passes near the host's enqueue time of their wrappers)."""
    per_solve = {**SOLVE3_LAUNCHES["cg"], **SOLVE3_LAUNCHES["bicg"]}
    import torch.nn.functional as F

    n = SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
    out, lib, graphs = {}, {}, {}
    for dim in DIMS3:
        kw = stencil_kw(lt, dim)
        ring = [inputs3d(torch, SHAPE3, 50 + s, device) for s in range(3)]
        for d in ring:
            d["alpha"] = d["alpha"] * 1e-3  # keep the in-place x, r bounded
            d["top"] = d["bot"] = None
            d["o1"], d["o2"] = torch.empty_like(d["x"]), torch.empty_like(d["x"])
        for name in (*KERNELS3, *BICG3_KERNELS):
            bpe = (KERNELS3[name][2] if name in KERNELS3
                   else BICG3_KERNELS[name][1])
            for comp in ((False, True) if name in BICG3_KERNELS
                         else (False,)):
                times = {}
                for plain in (False, True):
                    fns = [call3d(T3, TB3, name, d, kw, plain, comp,
                                  out=((d["o1"], d["o2"])
                                       if name == "bicg3d_pv" else d["o1"]))
                           for d in ring]
                    k = iter(range(10**9))
                    times[plain] = event_ms(
                        torch, lambda: fns[next(k) % 3](), 6 if plain else 30)
                    if not plain:
                        g_ms = graph_ms(torch, fns, 30)
                sane(f"{name} dim {dim}", times[False], bpe * n, bw)
                sane(f"{name} dim {dim} (graph)", g_ms, bpe * n, bw)
                out[name, dim, comp] = (times[False], times[True])
                graphs[name, dim, comp] = g_ms
                gbps = bpe * n / times[False] / 1e6
                bound = max(bpe * n / bw * 1e3, ops_per_elt(
                    name, len(kw["offsets"])) * n / F32_PEAK * 1e3)
                launches = per_solve.get(name, 0)
                log(f"[time3d] {name:13s} dim {dim} compensated={comp!s:5s} "
                    f"kernel {times[False]:.4f} ms ({gbps:.1f} GB/s, "
                    f"{100 * bound / times[False]:.1f}% of its "
                    f"{bound:.4f} ms bound; in CUDA graphs {g_ms:.4f} ms, "
                    f"{100 * bound / g_ms:.1f}%), plain {times[True]:.4f} ms; "
                    f"{launches} launches per solve({N_ITERS}), "
                    f"{launches * (times[False] - bound):.1f} ms lost per "
                    f"solve at 256^3 f32 on {card}")
        w = torch.zeros(1, 1, 3, 3, 3, device=device)
        for (ox, oy, oz), v in zip(kw["offsets"], kw["values"]):
            w[0, 0, 1 + ox, 1 + oy, 1 + oz] = v
        conv = [lambda d=d: F.conv3d(d["x"][None, None], w, padding=1)
                for d in ring]
        y_lib = conv[0]()[0, 0]
        y_ker = T3.grid3d_stencil_matvec(ring[0]["x"], **kw)
        err = (y_lib - y_ker).abs().max().item()
        if err > 1e-5 * y_ker.abs().max().item():
            raise AssertionError(f"F.conv3d disagrees with K6a y: {err:g}")
        k = iter(range(10**9))
        lib[dim] = event_ms(torch, lambda: conv[next(k) % 3](), 30)
        log(f"[time3d] F.conv3d y dim {dim}: {lib[dim]:.4f} ms (max abs "
            f"diff from K6a y {err:.3g}) at 256^3 f32 on {card}")
        del ring, conv
    return out, lib, graphs


def time_pv_turns(torch, lt, T3, TB3, device, card):
    """Phase 5e.  K7 pv with compensated dots off, on, on, off (CUDA events
    over a ring of three input sets at 256^3, as in time_3d_kernels), for
    the 7- and 27-point stencils (march1) and REACH2 (the window march):
    {dim: [ms per turn]}."""
    res = {}
    for dim in (*DIMS3, REACH2):
        kw = stencil_kw(lt, dim)
        ring = [inputs3d(torch, SHAPE3, 70 + s, device) for s in range(3)]
        for d in ring:
            d["top"] = d["bot"] = None
        outs = (torch.empty_like(ring[0]["x"]), torch.empty_like(ring[0]["x"]))
        res[dim] = []
        for comp in (False, True, True, False):
            fns = [call3d(T3, TB3, "bicg3d_pv", d, kw, False, comp, out=outs)
                   for d in ring]
            k = iter(range(10**9))
            res[dim].append(event_ms(torch, lambda: fns[next(k) % 3](), 30))
        log(f"[time3d] bicg3d_pv dim {dim} compensated off, on, on, off: "
            + ", ".join(f"{t:.4f}" for t in res[dim])
            + f" ms at 256^3 f32 on {card}")
        del ring
    return res


def solve_once(torch, solver, n_iters):
    """(device ms, host enqueue ms) of one ``solve(n_iters)`` after a reset
    outside the timing: CUDA events around the solve, and the host's clock
    until ``solve`` returns."""
    restart(solver)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    solver.solve(n_iters)
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    return start.elapsed_time(end), host * 1e3


def solve_ms(torch, solver, n_iters, ctx=None):
    """:func:`solve_once`, the better of two runs after a warm-up run.
    ``ctx`` (a plain_driven) swaps in plain versions."""
    if ctx:
        ctx.__enter__()
    try:
        runs = [solve_once(torch, solver, n_iters) for _ in range(3)]
    finally:
        if ctx:
            ctx.__exit__(None, None, None)
    return min(runs[1:])


def time_3d_solves(torch, T3, TB3, solvers, bw, card):
    """Phase 5f.  {(solver, dim, label): (ms/iter, host ms/iter)} of
    solve(200) at 256^3, kernel- and plain-driven."""
    n = SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
    # CG: pq + update (24 B) then 199 x (xpay_pq + update, 32 B);
    # BiCGStab: 60 B/iteration + the two bootstrap dots (16 B)
    nbytes = {"cg": (24 + 32 * (N_ITERS - 1)) * n,
              "bicg": (60 * N_ITERS + 16) * n}
    res = {}
    for (kind, dim), solver in solvers.items():
        plain = cg3d_plain(T3) if kind == "cg" else bicg3d_plain(TB3)
        module = T3 if kind == "cg" else TB3
        for label in ("kernel", "plain"):
            ctx = plain_driven(module, solver, plain) if label == "plain" \
                else None
            ms, host = solve_ms(torch, solver, N_ITERS, ctx)
            sane(f"{kind} dim {dim} solve {label}", ms, nbytes[kind], bw)
            res[kind, dim, label] = (ms / N_ITERS, host / N_ITERS)
            log(f"[time3d] {kind} dim {dim} solve({N_ITERS}) {label}-driven: "
                f"{ms / N_ITERS:.4f} ms/iter ({nbytes[kind] / ms / 1e6:.1f} "
                f"GB/s effective; host enqueue {host / N_ITERS:.4f} ms/iter)"
                f" at 256^3 f32 on {card}")
    return res


def conv2d_y(torch, T, device, card, terms, seed, what):
    """F.conv2d (cuDNN, TF32 off) computing K3's y at 4096^2 for the 2-D
    stencil ``terms`` ({(dy, dx): v} pairs) over its dense box, zero padded
    (the kernels' zero columns and null halo blocks), held to K3's y: ms
    over a ring of three inputs."""
    import torch.nn.functional as F

    hy = max(abs(dy) for (dy, _), _ in terms)
    hx = max(abs(dx) for (_, dx), _ in terms)
    w = torch.zeros(1, 1, 2 * hy + 1, 2 * hx + 1, device=device)
    for (dy, dx), v in terms:
        w[0, 0, hy + dy, hx + dx] = v
    g = torch.Generator(device=device).manual_seed(seed)
    ring = [torch.randn(N_GRID, N_GRID, generator=g, device=device)
            for _ in range(3)]
    y_ker = T.grid2d_stencil_matvec(ring[0], **terms_kw(terms))
    y_lib = F.conv2d(ring[0][None, None], w, padding=(hy, hx))[0, 0]
    err = (y_lib - y_ker).abs().max().item()
    if err > 1e-5 * y_ker.abs().max().item():
        raise AssertionError(f"F.conv2d disagrees with K3 y {what}: {err:g}")
    k = iter(range(10**9))
    ms = event_ms(torch, lambda: F.conv2d(ring[next(k) % 3][None, None], w,
                                          padding=(hy, hx)), 30)
    log(f"[time] F.conv2d y {what} ({2 * hy + 1} x {2 * hx + 1} box): "
        f"{ms:.4f} ms (max abs diff from K3 y {err:.3g}) at {N_GRID}^2 f32 "
        f"on {card}")
    return ms


def library_2d(torch, T, device, card):
    """F.conv2d computing K3's y with the cross at 4096^2
    (:func:`conv2d_y`)."""
    return conv2d_y(torch, T, device, card, tuple(zip(OFFS, VALS)), 61,
                    "with the cross")


# ---------------------------------------------------------------------------
# the explicit-sparse path: 4e-g (build the three systems, drive CG and
# BiCGStab), 3e (K8, K9, K10 against their plain versions), 5g (timing)
# ---------------------------------------------------------------------------

DIA_CSRC = "legionsolvers_tpu_torch/csrc/dia2d.cu"
WINELL_CSRC = "legionsolvers_tpu_torch/csrc/winell.cu"
ROWPERM_CSRC = "legionsolvers_tpu_torch/csrc/rowperm.cu"
# counter name -> (row name, source, the pallas_call it replaces)
KERNELS_X = {
    "dia2d": ("dia2d_matvec", DIA_CSRC,
              "legionsolvers_tpu/ops/pallas/dia2d.py:235"),
    "dia2d_dot": ("dia2d_matvec(with_dot)", DIA_CSRC,
                  "legionsolvers_tpu/ops/pallas/dia2d.py:235"),
    "winell": ("winell_spmv", WINELL_CSRC,
               "legionsolvers_tpu/ops/pallas/winell.py:141"),
    "blockperm": ("blockperm_gather (the six hops of one routed matvec)",
                  ROWPERM_CSRC, "legionsolvers_tpu/ops/pallas/rowperm.py:132"),
}
EXPLICIT = ("dia", "scrambled", "random")
# what the planner must pick: operator chain and plan geometry
WANT_CHAIN = {"dia": ["DiaOperator"],
              "scrambled": ["ReorderedOperator", "WinEllOperator"],
              "random": ["ReorderedOperator", "GeneralSpmvOperator"]}
WANT_GEOMETRY = {"dia": {"C": N_GRID, "D": 5},
                 "scrambled": {"KR": 24, "L": 5, "Rt": 8},
                 "random": {"hops": 6}}
# iterations before the ||b - Ax||^2 check: the last one, except on the
# random system, where the f32 recurrences fall below f32's attainable
# accuracy within a few iterations (BiCGStab's within three)
GAP_AT = {("cg", "dia"): N_ITERS, ("cg", "scrambled"): N_ITERS,
          ("cg", "random"): 4, ("bicgstab", "random"): 2}
X_GAP_FLOOR = 1e-3   # ||b - Ax||^2 vs history: twice textbook f32, or this
X_F64_FLOOR = 1e-4   # history and x vs float64: twice textbook f32, or this
EAGER_X_RTOL = 1e-5  # eager step()s vs the solve: other summation orders
GRADED_N, GRADED_BW = 1 << 20, 512


def chain(op):
    return [type(op).__name__] + (chain(op.base) if hasattr(op, "base")
                                  else [])


def explicit_coo(np, lt, name):
    """(rows, cols, vals, n, scramble) of one explicit system, made with
    numpy from its seed; ``scramble`` is the row/column permutation of the
    scrambled Laplacian (None otherwise)."""
    if name in ("dia", "scrambled"):
        nx = N_GRID if name == "dia" else N_GRID // 2
        a = lt.create_coo_stencil_matrix((nx, nx), lt.laplacian_stencil(2))
        rows, cols, vals, n = a.rows, a.cols, np.asarray(a.vals), a.n_range
        if name == "dia":
            return rows, cols, vals, n, None
        pr = np.random.default_rng(0).permutation(n)
        return pr[rows], pr[cols], vals, n, pr
    n = 1 << 20
    rng = np.random.default_rng(1)
    m = 4 * n
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    vals = rng.uniform(-1, 1, m)
    return (np.concatenate([rows, cols, np.arange(n)]),
            np.concatenate([cols, rows, np.arange(n)]),
            np.concatenate([vals, vals, np.full(n, 16.0)]), n, None)


def build_explicit(torch, np, lt, name, device):
    """Phase 4e-g, the build: the system through build_explicit_system,
    host seconds, and the operator chain and geometry checked."""
    from legionsolvers_tpu_torch.entry import build_explicit_system

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    t0 = time.perf_counter()
    rows, cols, vals, n, pr = explicit_coo(np, lt, name)
    A = lt.COOMatrix(rows, cols, vals, n, n, options=f32)
    t1 = time.perf_counter()
    planner = build_explicit_system(A, f32, device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    op = planner.row_partitioned_matrices[0][0]
    base = getattr(op, "base", op)
    if name == "dia":
        geo = {"C": base._view["C"], "D": len(base._view["offs"])}
    elif name == "scrambled":
        geo = {"KR": base.window_rows, "L": base.row_length,
               "Rt": base.tile_rows_of_128}
    else:
        geo = {k: base._plan[k] for k in ("B1", "G2", "W2", "SRB3", "BR3",
                                          "V")}
        geo["hops"] = base.launches_per_matvec
    ok = base.uses_pallas and all(geo[k] == v
                                  for k, v in WANT_GEOMETRY[name].items())
    log(f"[explicit] {name}: n {n}, nnz {A.n_kernel}; matrix {t1 - t0:.1f} s,"
        f" planner {t2 - t1:.1f} s on the host; {chain(op)} {geo}")
    if chain(op) != WANT_CHAIN[name] or not ok:
        raise AssertionError(f"{name}: the planner picked {chain(op)} {geo}")
    return {"planner": planner, "coo": (rows, cols, vals, n), "pr": pr,
            "host_s": (t1 - t0, t2 - t1), "geometry": geo, "nnz": A.n_kernel}


def csr_of(torch, rows, cols, vals, n, device):
    """The f32 matrix as a torch CSR tensor on ``device`` (cuSPARSE's
    input), duplicates summed; built on the device."""
    import warnings

    idx = torch.stack([torch.as_tensor(rows, device=device),
                       torch.as_tensor(cols, device=device)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch's beta notice
        coo = torch.sparse_coo_tensor(
            idx, torch.as_tensor(vals, dtype=torch.float32, device=device),
            (n, n), check_invariants=False)
        return coo.coalesce().to_sparse_csr()


# -- phase 3e ----------------------------------------------------------------

def capture_hops(op, x):
    """The (hop, src, idx, vals) of every K10 call in one matvec of ``op``."""
    from legionsolvers_tpu_torch.parallel import genspmv

    calls, real = [], genspmv.gather_hop

    def record(hop, src, idx, vals=None):
        calls.append((hop, src, idx, vals))
        return real(hop, src, idx, vals)

    genspmv.gather_hop = record
    try:
        op.matvec(x)
    finally:
        genspmv.gather_hop = real
    return calls


def compare_explicit_kernels(torch, np, lt, T, systems, device):
    """Phase 3e.  Returns {counter name: max abs error}."""
    from legionsolvers_tpu_torch.ops.cuda import dia2d as TD
    from legionsolvers_tpu_torch.ops.cuda import rowperm as RP
    from legionsolvers_tpu_torch.ops.cuda import winell as TW
    from legionsolvers_tpu_torch.parallel import winell_op

    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = {}
    g = torch.Generator(device=device).manual_seed(71)
    dia = systems["dia"]["planner"].row_partitioned_matrices[0][0]
    offs = dia._view["offs"]
    cases = [(tuple(dia._view["diags"].shape[1:]), offs, dia._view["diags"]),
             (RAGGED, ((-8, 3), (0, 0), (2, -200), (5, 130), (8, -1)), None)]
    for shape, offsets, diags in cases:
        R, C = shape
        x = torch.randn(shape, generator=g, device=device)
        top, bot = (torch.randn(8, C, generator=g, device=device)
                    for _ in range(2))
        if diags is None:
            diags = torch.randn(len(offsets), R, C, generator=g,
                                device=device)
        for with_dot in (False, True):
            got = TD.dia2d_matvec(x, top, bot, diags, offsets=offsets,
                                  with_dot=with_dot)
            want = TD.dia2d_plain(x, top, bot, diags, offsets=offsets,
                                  with_dot=with_dot)
            torch.cuda.synchronize()
            derr = 0.0
            if with_dot:
                (got, gdot), (want, wdot) = got, want
                derr = abs(gdot.item() - wdot.item())
                if derr > 1e-4 * nrm(x) * nrm(want):
                    raise AssertionError(f"K8 dot {shape}: {derr:g}")
            err = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"K8 {shape} with_dot={with_dot}: y "
                                     f"differs from the plain version "
                                     f"(max abs err {err:g})")
            key = "dia2d_dot" if with_dot else "dia2d"
            errs[key] = max(errs.get(key, 0.0), err, derr)
            log(f"[check-x] K8 {shape} D={len(offsets)} with_dot={with_dot}:"
                f" y == plain bit for bit" + (f", dot err {derr:.3g}"
                                              if with_dot else ""))

    w = systems["scrambled"]["planner"].row_partitioned_matrices[0][0].base
    x2d = torch.randn(w._N // 128, 128, generator=g, device=device)
    args = (x2d, w.wstart, w.ell_cols, w.ell_vals)
    got = TW.winell_spmv(*args, window_rows=w.window_rows)
    want = TW.winell_plain(*args, window_rows=w.window_rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K9 differs from its plain version")
    errs["winell"] = 0.0
    log(f"[check-x] K9 on the scrambled plan {tuple(w.ell_cols.shape)}: "
        "== plain bit for bit")

    rng = np.random.default_rng(3)
    deg = (3 + 24 * (np.arange(GRADED_N) / GRADED_N)).astype(np.int64)
    rows = np.repeat(np.arange(GRADED_N), deg)
    cols = rows + rng.integers(-GRADED_BW, GRADED_BW + 1, len(rows))
    keep = (cols >= 0) & (cols < GRADED_N)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1, 1, len(rows))
    t0 = time.perf_counter()
    sliced = lt.SlicedWinEllOperator(
        lt.COOMatrix(rows, cols, vals, GRADED_N, GRADED_N,
                     options=lt.SolverOptions()),
        lt.BlockPartition(GRADED_N, 1), lt.SolverOptions(), device=device)
    host = time.perf_counter() - t0
    xs = torch.randn(GRADED_N, generator=g, device=device)
    T.reset_launch_counts()
    y_k = sliced.matvec(xs)
    launched = dict(T.LAUNCHES)
    winell_op.winell_spmv = TW.winell_plain
    try:
        y_p = sliced.matvec(xs)
    finally:
        winell_op.winell_spmv = TW.winell_spmv
    torch.cuda.synchronize()
    if not torch.equal(y_k, y_p) or launched != {
            "winell": len(sliced._class_meta)}:
        raise AssertionError(f"sliced windowed ELL: kernel != plain or "
                             f"launches {launched}")
    log(f"[check-x] SlicedWinEllOperator, graded band n {GRADED_N}, "
        f"{len(rows)} nnz, {len(sliced._class_meta)} classes (KR "
        f"{[kr for _, kr in sliced._class_meta]}; host plan {host:.1f} s): "
        "matvec == plain-driven bit for bit")
    del sliced, rows, cols, vals

    gop = systems["random"]["planner"].row_partitioned_matrices[0][0].base
    xg = torch.randn(gop.partition.padded_size, generator=g, device=device)
    hops = capture_hops(gop, xg)
    for dtype in (torch.float32, torch.float64):
        for i, (hop, src, idx, vals) in enumerate(hops):
            src = src.to(dtype)
            vals = None if vals is None else vals.to(dtype)
            got = RP.gather_hop(hop, src, idx, vals)
            want = RP.blockperm_plain(src, idx, vals, **hop.kwargs())
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K10 hop {i} {dtype} differs from its "
                                     "plain version")
    errs["blockperm"] = 0.0
    log(f"[check-x] K10: {len(hops)} hops of the 2^20 plan (block rows, "
        "source rows, w_rows: "
        + ", ".join(f"{h.block_rows}/{h.src_block_rows}/{h.w_rows}"
                    + ("s" if v is not None else "")
                    for h, _, _, v in hops)
        + "), f32 and f64: == plain bit for bit")
    return errs


# K10 at the interface's caps (block_rows 256, src_block_rows 64, w_rows 8):
# one run of 256 rows over the last window (staged in shared memory; 64 KB
# in f64), and runs of one row over windows that move by 7 rows (gathered
# from global memory), f32 and f64, scaled and not
K10_CAP_BLOCKS = 6


def compare_blockperm_caps(torch, device):
    """Phase 3e, K10 at its caps against blockperm_plain, bit for bit."""
    from legionsolvers_tpu_torch.ops.cuda import rowperm as RP

    br, srb, w = RP.MAX_BLOCK_ROWS, RP.MAX_SRC_ROWS, RP.MAX_W_ROWS
    g = torch.Generator(device=device).manual_seed(37)
    RD = K10_CAP_BLOCKS * br
    idx = torch.randint(0, w * 1024, (RD, 1024), generator=g,
                        dtype=torch.int32, device=device)
    for run, tab in ((br, (srb - w,) * br),
                     (1, tuple((7 * dl) % (srb - w + 1) for dl in range(br)))):
        hop = RP.GatherHop(br, srb, tab, w, device)
        if hop.stage != (run >= w):
            raise AssertionError(f"K10 runs of {run}: stage {hop.stage}")
        for dtype in (torch.float32, torch.float64):
            src = torch.randn(K10_CAP_BLOCKS * srb * 1024, generator=g,
                              dtype=dtype, device=device)
            vals = torch.randn(RD, 1024, generator=g, dtype=dtype,
                               device=device)
            for v in (None, vals):
                got = RP.gather_hop(hop, src, idx, v)
                want = RP.blockperm_plain(src, idx, v, **hop.kwargs())
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K10 caps, runs of {run}, {dtype}, scaled="
                        f"{v is not None}: differs from its plain version")
        log(f"[check-x] K10 at block_rows {br}, src_block_rows {srb}, w_rows "
            f"{w}, runs of {run} ({'staged' if hop.stage else 'direct'}), "
            "f32 and f64, scaled and not: == plain bit for bit")


# -- phases 4e-g ---------------------------------------------------------------

def textbook_cg_scipy(np, S, iters, dtype):
    """Textbook CG on the scipy matrix ``S``, b = 1, in numpy ``dtype``:
    (history, x), float64."""
    S = S.astype(dtype)
    b = np.ones(S.shape[0], dtype)
    x, r, p = b * 0, b.copy(), b.copy()
    rr = r @ r
    hist = [rr]
    with np.errstate(all="ignore"):
        for _ in range(iters):
            q = S @ p
            a = rr / (p @ q)
            x = x + a * p
            r = r - a * q
            rr_new = r @ r
            hist.append(rr_new)
            p = r + (rr_new / rr) * p
            rr = rr_new
    return np.array(hist, np.float64), x.astype(np.float64)


def textbook_bicgstab_scipy(np, S, iters, dtype):
    S = S.astype(dtype)
    b = np.ones(S.shape[0], dtype)
    x, r, rt = b * 0, b.copy(), b.copy()
    p, v = b * 0, b * 0
    rho, alpha, omega = dtype(1), dtype(0), dtype(1)
    hist = [r @ r]
    with np.errstate(all="ignore"):
        for _ in range(iters):
            rho_new = r @ rt
            beta = (rho_new / rho) * (alpha / omega)
            rho = rho_new
            p = r + beta * (p - omega * v)
            v = S @ p
            alpha = rho / (rt @ v)
            s = r - alpha * v
            t = S @ s
            omega = (t @ s) / (t @ t)
            x = x + alpha * p + omega * s
            r = s - omega * t
            hist.append(r @ r)
    return np.array(hist, np.float64), x.astype(np.float64)


def explicit_refs(torch, np, sysd, name, device, solver="cg"):
    """Float64 and textbook f32 references of one system: {"h64", "x64",
    "h32", "x32"} (float64 torch tensors on ``device``, x in the port's
    ordering) and ``true_rr(x)``, ||1 - A x||^2 in float64."""
    rows, cols, vals, n = sysd["coo"]
    if name in ("dia", "scrambled"):
        nx = int(round(n ** 0.5))
        h64, x64 = classic_cg(torch, (nx, nx), N_ITERS, torch.float64, device)
        h32, x32 = classic_cg(torch, (nx, nx), N_ITERS, torch.float32, device)
        pr = sysd["pr"]
        prt = None if pr is None else torch.as_tensor(pr, device=device)

        def to_port(x):
            x = x.reshape(-1)
            if prt is None:
                return x
            out = torch.empty_like(x)
            out[prt] = x
            return out

        def true_rr(x):
            x = x.double().reshape(-1)
            g = x if prt is None else x[prt]
            return torch.sum((1.0 - lap5(g.reshape(nx, nx))) ** 2).item()

        return ({"h64": h64, "x64": to_port(x64), "h32": h32,
                 "x32": to_port(x32)}, true_rr)
    import scipy.sparse as sp

    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    fn = textbook_cg_scipy if solver == "cg" else textbook_bicgstab_scipy
    out = {}
    for key, dt in (("64", np.float64), ("32", np.float32)):
        h, x = fn(np, S, N_ITERS, dt)
        out["h" + key] = torch.as_tensor(h, device=device)
        out["x" + key] = torch.as_tensor(x, device=device)

    def true_rr(x):
        xh = x.double().reshape(-1).cpu().numpy()[:n]
        return float(np.sum((1.0 - S @ xh) ** 2))

    return out, true_rr


def finite_window(torch, *hists):
    """Leading entries where every history is finite and positive."""
    ok = None
    for h in hists:
        f = torch.isfinite(h) & (h > 0)
        ok = f if ok is None else ok & f
    bad = (~ok).nonzero()
    return int(bad[0]) if len(bad) else len(ok)


def explicit_path(torch, T, lt, name, sysd, refs, true_rr, device,
                  kind="cg"):
    """Phase 4e, 4f or 4g on one system: eager ``step()``s (CG only),
    ``solve(200)``, the same solve again (bit-identical, NaNs included),
    ``solve(GAP_AT[name])`` and ||b - Ax||^2 through ``planner.matvec``
    against its last entry, every kernel launch counted; then the history
    and x against float64.  Returns (counts, results, solver, failed)."""
    planner = sysd["planner"]
    op = planner.row_partitioned_matrices[0][0]
    solver = (lt.CGSolver(planner) if kind == "cg"
              else lt.BiCGStabSolver(planner))
    scratch = solver.Q if kind == "cg" else solver.U
    b = planner.rhs_vectors[0].data
    torch.cuda.synchronize()
    gap_at = GAP_AT[kind, name]

    T.reset_launch_counts()
    eager = None
    if kind == "cg":
        for _ in range(N_EAGER):
            solver.step()
        eager = torch.stack([s.value for s in solver.residual_norm_squared])
    restart(solver)
    hist = solver.solve(N_ITERS)
    after = dict(T.LAUNCHES)
    x = planner.sol_vectors[0].data.clone()
    restart(solver)
    hist2 = solver.solve(N_ITERS)
    repeat = same_bits(hist, hist2) and same_bits(
        x, planner.sol_vectors[0].data)
    restart(solver)
    h_gap = solver.solve(gap_at)
    planner.matvec(scratch, solver.SOL)
    torch.cuda.synchronize()
    counts = dict(T.LAUNCHES)
    T.reset_launch_counts()
    rr_true = torch.sum((b - planner.get_vector(scratch, 0).data).double()
                        ** 2).item()
    gap = abs(rr_true - h_gap[-1].item()) / h_gap[-1].item()

    h64, x64, h32, x32 = (refs[k] for k in ("h64", "x64", "h32", "x32"))
    win = finite_window(torch, hist.double(), h64, h32)
    agree = (agree_window(h32, h64), agree_window(hist, h64))
    dev_k = rel_dev(hist[:win], h64[:win]).max().item()
    dev_t = rel_dev(h32[:win], h64[:win]).max().item()
    finite_x = bool(torch.isfinite(x).all())
    xk = x_rel(x, x64) if finite_x else float("nan")
    xt = x_rel(x32, x64) if bool(torch.isfinite(x32).all()) else float("nan")
    # the textbook f32 run's own true-residual gap at the same iteration
    if kind == "cg" and gap_at == N_ITERS:
        gap32 = abs(true_rr(x32) - h32[-1].item()) / h32[-1].item()
    else:
        gap32 = 0.0
    first_bad = lambda h: (None if bool(torch.isfinite(h).all())
                           else int((~torch.isfinite(h)).nonzero()[0]))
    hops = getattr(getattr(op, "base", op), "launches_per_matvec", 1)
    per_mv = {"dia": ("dia2d_dot", "dia2d"), "scrambled": ("winell",) * 2,
              "random": ("blockperm",) * 2}[name]
    n_mv = (1 if kind == "cg" else 2)
    want_after = {per_mv[0]: hops * n_mv * N_ITERS}
    if eager is not None:
        want_after[per_mv[0]] += hops * N_EAGER
    want = dict(want_after)
    want[per_mv[0]] += hops * n_mv * (N_ITERS + gap_at)
    want[per_mv[1]] = want.get(per_mv[1], 0) + hops
    eager_dev = (rel_dev(eager, hist[:N_EAGER + 1]).max().item()
                 if eager is not None else 0.0)
    log(f"[{kind}-x] {name}: launches {after}, then {counts}; repeat "
        f"bit-identical {repeat}; eager vs solve rel dev {eager_dev:.3g}; "
        f"residual^2 {hist[0].item():.6g} -> {hist[-1].item():.6g} (float64 "
        f"{h64[-1].item():.6g}); first non-finite entry: kernel "
        f"{first_bad(hist)}, textbook f32 {first_bad(h32)}, float64 "
        f"{first_bad(h64)}; after {gap_at}: ||b-Ax||^2 {rr_true:.6g} vs "
        f"history {h_gap[-1].item():.6g} (rel {gap:.3g}; textbook f32 "
        f"{gap32:.3g}); entries within 1e-3 of float64: textbook f32 "
        f"{agree[0]}, kernel {agree[1]}; against float64 over the {win} "
        f"finite entries (history, x max rel): kernel {dev_k:.3g} {xk:.3g}, "
        f"textbook f32 {dev_t:.3g} {xt:.3g}")
    checks = {
        "launches": after == want_after and counts == want,
        "two solves from one state are bit-identical": repeat,
        "b intact": bool((b == 1.0).all()),
        f"eager step() vs solve, rtol {EAGER_X_RTOL}":
            eager_dev <= EAGER_X_RTOL,
        f"||b - Ax||^2 vs history after {gap_at}, within twice textbook "
        f"f32's gap (or {X_GAP_FLOOR})": gap <= max(2 * gap32, X_GAP_FLOOR),
        "the kernel path stays finite as long as textbook f32 does":
            win >= finite_window(torch, h32, h64),
        "the kernel path stays within 1e-3 of float64 as long as textbook "
        "f32 does": agree[1] >= agree[0],
        "history within twice textbook f32's distance from float64 (floor "
        f"{X_F64_FLOOR})": dev_k <= max(2 * dev_t, X_F64_FLOOR),
    }
    if bool(torch.isfinite(x32).all()):  # else both broke down
        checks[f"x within twice textbook f32's distance (floor "
               f"{X_F64_FLOOR})"] = finite_x and xk <= max(2 * xt,
                                                           X_F64_FLOOR)
    failed = [f"{kind}-x {name}: {k}" for k, ok in checks.items() if not ok]
    results = {"hist_first_last": (hist[0].item(), hist[-1].item()),
               "first_nonfinite": (first_bad(hist), first_bad(h32),
                                   first_bad(h64)),
               "true_rr": rr_true, "gap": gap, "gap_textbook": gap32,
               "eager_dev": eager_dev, "window": win, "agree": agree,
               "vs_f64": {"kernel": (dev_k, xk), "textbook f32": (dev_t, xt)},
               "checks": checks}
    del x
    return counts, results, solver, failed


# -- phase 5g ------------------------------------------------------------------

def time_explicit(torch, np, lt, systems, solvers, bw, card, device):
    """Phase 5g.  Returns ({counter name: (ms, plain ms, bytes, flops,
    library ms)}, {system: (ms/iter, host ms/iter)}, extra)."""
    from legionsolvers_tpu_torch.ops.cuda import dia2d as TD
    from legionsolvers_tpu_torch.ops.cuda import rowperm as RP
    from legionsolvers_tpu_torch.ops.cuda import winell as TW

    g = torch.Generator(device=device).manual_seed(83)
    out, extra = {}, {}

    def ring_ms(fns, reps):
        k = iter(range(10**9))
        return event_ms(torch, lambda: fns[next(k) % len(fns)](), reps)

    # K8 at 4096^2, D = 5, on the DIA system's coefficients
    dsys = systems["dia"]
    dia = dsys["planner"].row_partitioned_matrices[0][0]
    diags, offs = dia._view["diags"], dia._view["offs"]
    n, D = N_GRID * N_GRID, len(offs)
    xs = [torch.randn(diags.shape[1:], generator=g, device=device)
          for _ in range(3)]
    csr = csr_of(torch, *dsys["coo"], device)
    y_lib = torch.mv(csr, xs[0].reshape(-1))
    y_ker = TD.dia2d_matvec(xs[0], None, None, diags, offsets=offs)
    lib_err = (y_lib - y_ker.reshape(-1)).abs().max().item()
    if lib_err > 1e-5 * y_ker.abs().max().item():
        raise AssertionError(f"cuSPARSE disagrees with K8: {lib_err:g}")
    lib_ms = ring_ms([lambda x=x: torch.mv(csr, x.reshape(-1)) for x in xs],
                     30)
    del csr, y_lib
    for key, with_dot in (("dia2d", False), ("dia2d_dot", True)):
        ms = ring_ms([lambda x=x: TD.dia2d_matvec(
            x, None, None, diags, offsets=offs, with_dot=with_dot)
            for x in xs], 30)
        plain = ring_ms([lambda x=x: TD.dia2d_plain(
            x, None, None, diags, offsets=offs, with_dot=with_dot)
            for x in xs], 6)
        nbytes = (2 + D) * 4 * n
        sane(key, ms, nbytes, bw)
        out[key] = (ms, plain, nbytes, (2 * D + 2 * with_dot) * n, lib_ms)
        log(f"[time-x] K8 {key}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s),"
            f" plain {plain:.4f} ms, cuSPARSE CSR SpMV {lib_ms:.4f} ms (max "
            f"abs diff {lib_err:.3g}) at {N_GRID}^2, D = {D}, f32 on {card}")
    del xs

    # K9 on the scrambled system's plan
    ssys = systems["scrambled"]
    w = ssys["planner"].row_partitioned_matrices[0][0].base
    nt, L, Rt, _ = w.ell_cols.shape
    xs = [torch.randn(w._N // 128, 128, generator=g, device=device)
          for _ in range(3)]
    args = lambda x: (x, w.wstart, w.ell_cols, w.ell_vals)
    pm = w.matrix
    csr = csr_of(torch, pm.rows, pm.cols, np.asarray(pm.vals),
                 w.partition.padded_size, device)
    nrow = w.partition.padded_size
    y_lib = torch.mv(csr, xs[0].reshape(-1)[:nrow])
    y_ker = TW.winell_spmv(*args(xs[0]), window_rows=w.window_rows)
    lib_err = (y_lib - y_ker.reshape(-1)[:nrow]).abs().max().item()
    if lib_err > 1e-5 * y_ker.abs().max().item():
        raise AssertionError(f"cuSPARSE disagrees with K9: {lib_err:g}")
    lib_ms = ring_ms([lambda x=x: torch.mv(csr, x.reshape(-1)[:nrow])
                      for x in xs], 30)
    del csr, y_lib
    ms = ring_ms([lambda x=x: TW.winell_spmv(*args(x),
                                             window_rows=w.window_rows)
                  for x in xs], 30)
    plain = ring_ms([lambda x=x: TW.winell_plain(*args(x),
                                                 window_rows=w.window_rows)
                     for x in xs], 6)
    slots = nt * L * Rt * 128
    nbytes = 8 * slots + 4 * nt * Rt * 128 + 4 * w._N
    sane("winell", ms, nbytes, bw)
    out["winell"] = (ms, plain, nbytes, 2 * slots, lib_ms)
    log(f"[time-x] K9 winell: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s; "
        f"{ssys['nnz'] / ms / 1e6:.2f} Gnnz/s), plain {plain:.4f} ms, "
        f"cuSPARSE CSR SpMV {lib_ms:.4f} ms (max abs diff {lib_err:.3g}) on "
        f"the scrambled 2048^2 plan (nt {nt}, L {L}, Rt {Rt}, KR "
        f"{w.window_rows}), f32 on {card}")
    del xs

    # K10: the six hops of one routed matvec, each timed over a ring of
    # three copies of its inputs.  A hop reads only the source elements its
    # windows reach (hop 5: 3 of every 24 rows), so its bytes count those,
    # from this run's index, not the whole source.  The small hops take
    # less time on the card than the host takes to enqueue them.  K10 and
    # torch.take are timed with CUDA events, as every other kernel is (the
    # kernels line's ms and library_ms), and also in CUDA graphs (device
    # time alone: graph_ms and library_graph_ms).
    rsys = systems["random"]
    gop = rsys["planner"].row_partitioned_matrices[0][0].base
    xg = torch.randn(gop.partition.padded_size, generator=g, device=device)
    hops = capture_hops(gop, xg)
    tot = {"ms": 0.0, "plain": 0.0, "take": 0.0, "bytes": 0, "flops": 0,
           "ms_graph": 0.0, "take_graph": 0.0}
    per_hop = []
    for i, (hop, src, idx, vals) in enumerate(hops):
        RD = idx.shape[0]
        br = hop.block_rows
        d = torch.arange(RD, device=device)
        w0 = torch.as_tensor(hop.w0_table, device=device)
        flat = ((d // br) * hop.src_block_rows
                + w0[d % br])[:, None] * 1024 + idx.long()
        if not torch.equal(torch.take(src, flat), RP.blockperm_plain(
                src, idx, None, **hop.kwargs())):
            raise AssertionError(f"torch.take disagrees with K10 hop {i}")
        src_read = torch.unique(flat).numel()
        ring = [(src, idx, vals, flat)] + [
            (src.clone(), idx.clone(),
             None if vals is None else vals.clone(), flat.clone())
            for _ in range(2)]
        kfns = [lambda r=r: RP.gather_hop(hop, *r[:3]) for r in ring]
        tfns = [lambda r=r: torch.take(r[0], r[3]) for r in ring]
        ms, take = ring_ms(kfns, 30), ring_ms(tfns, 30)
        ms_gr, take_gr = graph_ms(torch, kfns, 30), graph_ms(torch, tfns, 30)
        plain = ring_ms([lambda r=r: RP.blockperm_plain(
            *r[:3], **hop.kwargs()) for r in ring], 6)
        elems = RD * 1024
        nbytes = 4 * elems * (2 + (vals is not None)) + 4 * src_read
        sane(f"blockperm hop {i}", ms_gr, nbytes, bw)
        per_hop.append((RD, br, hop.src_block_rows, hop.w_rows,
                        vals is not None, hop.stage, src_read, ms, plain,
                        take, ms_gr, take_gr))
        tot["ms"] += ms
        tot["plain"] += plain
        tot["take"] += take
        tot["ms_graph"] += ms_gr
        tot["take_graph"] += take_gr
        tot["bytes"] += nbytes
        tot["flops"] += elems if vals is not None else 0
        del flat, ring
    out["blockperm"] = (tot["ms"], tot["plain"], tot["bytes"], tot["flops"],
                        tot["take"])
    log(f"[time-x] K10 blockperm, six hops of one 2^20 matvec: {tot['ms']:.4f}"
        f" ms ({tot['bytes'] / tot['ms'] / 1e6:.1f} GB/s), plain "
        f"{tot['plain']:.4f} ms, torch.take {tot['take']:.4f} ms (CUDA "
        f"events, the host's enqueue included); in CUDA graphs: K10 "
        f"{tot['ms_graph']:.4f} ms, torch.take {tot['take_graph']:.4f} ms; "
        "per hop (rows, block, source rows, w_rows, scaled, staged, source "
        "elements read, ms, plain, take, ms graph, take graph): "
        + "; ".join(" ".join(f"{v:.4f}" if isinstance(v, float) else str(v)
                             for v in h) for h in per_hop)
        + f" (f32 on {card})")
    extra["K10_hops"] = per_hop
    extra["K10_graph_ms"] = (tot["ms_graph"], tot["take_graph"])

    # the whole routed matvec against cuSPARSE on the same basis
    pm = gop.matrix
    csr = csr_of(torch, pm.rows, pm.cols, np.asarray(pm.vals),
                 gop.partition.padded_size, device)
    y_lib = torch.mv(csr, xg)
    y_ker = gop.matvec(xg)
    lib_err = (y_lib - y_ker).abs().max().item()
    if lib_err > 1e-5 * y_ker.abs().max().item():
        raise AssertionError(f"cuSPARSE disagrees with genspmv: {lib_err:g}")
    mv_ms = event_ms(torch, lambda: gop.matvec(xg), 30)
    mv_lib = event_ms(torch, lambda: torch.mv(csr, xg), 30)
    extra["genspmv_matvec_ms"] = (mv_ms, mv_lib)
    log(f"[time-x] routed matvec (6 x K10 + transposes + sums): {mv_ms:.4f} "
        f"ms ({rsys['nnz'] / mv_ms / 1e6:.2f} Gnnz/s), cuSPARSE CSR SpMV "
        f"{mv_lib:.4f} ms (max abs diff {lib_err:.3g}) at n 2^20, f32 on "
        f"{card}")
    del csr, y_lib

    # the three CG solves
    # B/unknown/iteration besides the matvec: two axpys 24, <r, r> 4,
    # <p, q> 8 (inside K8 on the DIA system), xpay 12
    vec_bytes = 48
    solves = {}
    for name in EXPLICIT:
        solver = solvers[name]
        n = systems[name]["coo"][3]
        mv_bytes = {"dia": out["dia2d_dot"][2],
                    "scrambled": out["winell"][2],
                    "random": out["blockperm"][2]}[name]
        vb = vec_bytes - (8 if name == "dia" else 0)  # the dot is in K8
        nbytes = (mv_bytes + vb * n) * N_ITERS
        ms, host = solve_ms(torch, solver, N_ITERS)
        sane(f"explicit CG {name}", ms, nbytes, bw)
        solves[name] = (ms / N_ITERS, host / N_ITERS)
        log(f"[time-x] CG solve({N_ITERS}) {name}: {ms / N_ITERS:.4f} ms/iter "
            f"({systems[name]['nnz'] / (ms / N_ITERS) / 1e6:.2f} Gnnz/s, "
            f"{nbytes / ms / 1e6:.1f} GB/s of the schedule's minimum "
            f"bytes; host enqueue {host / N_ITERS:.4f} ms/iter) on {card}")
    return out, solves, extra


# ---------------------------------------------------------------------------
# the benchmark CLI path: 3h (K11, K12 against their plain versions), 4h
# (``benchmark.main`` at full width and ``utils/probe_roofline``), 5h
# (timing of the probes and the CLI runs)
# ---------------------------------------------------------------------------

K11_CSRC = "legionsolvers_tpu_torch/csrc/vpu_probe.cu"
K11_PALLAS = "legionsolvers_tpu/utils/vpu_probe.py:70"
K12_CSRC = "legionsolvers_tpu_torch/csrc/copy_probe.cu"
K12_PALLAS = "scripts/probe_roofline.py:83"
K11_REPS = (1, 2, 16)
K11_ROW_REPS = 256   # loop trips per launch in the kernels line's K11 rows
K12_SHAPES = ((16384, 4096), RAGGED)
K12_RAGGED = (1000003,)  # n % 4 == 3: a vector body and the scalar rest
K12_RINGS = 12  # phase 5h: rings of K12, torch.add, torch.add, K12
K12_SOLVES_RINGS = 4  # --solves: rings of K12, add, add, K12
# shared-memory bytes an SM moves per clock (Hopper), K11 roll and row's
# ceiling: each chain step moves 8 B through shared memory
SMEM_B_PER_CLOCK = 128
CLI_2D = ["-dim", "2", "-nx", "4096", "-ny", "4096"]
CLI_3D = ["-dim", "3", "-nx", "256", "-ny", "256", "-nz", "256"]
CLI_RUNS = {
    "cg 2d": CLI_2D + ["-solver", "1", "-it", "200"],
    "bicgstab 2d": CLI_2D + ["-solver", "2", "-it", "200"],
    "pcg 2d": CLI_2D + ["-solver", "4", "-it", "200"],
    "gmres 2d": CLI_2D + ["-solver", "3", "-restart", "10", "-it", "20"],
    "gmres 3d": CLI_3D + ["-solver", "3", "-restart", "10", "-it", "20"],
    "pcg 3d": CLI_3D + ["-solver", "4", "-it", "200"],
}
# GMRES's residual is non-increasing in exact arithmetic; in f32 each
# cycle recomputes ||b - Ax||^2 from a new x, a sum of 16.7M rounded
# squares, so successive entries may rise by rounding: held to 1e-3
GMRES_SLACK = 1e-3
F64_CARD_RTOL = 1e-8


def compare_probe_kernels(torch, device):
    """Phase 3h.  K11 (three kinds, reps 1, 2, 16) on the probe's tile: roll
    and row bit for bit, fma to ``fma_rtol``; K12 bit for bit at the
    probe's shape and a ragged one.  Returns {row: max abs error}."""
    from legionsolvers_tpu_torch.ops.cuda import copy_probe as K12
    from legionsolvers_tpu_torch.ops.cuda import vpu_probe as K11

    g = torch.Generator(device=device).manual_seed(71)
    x = torch.randn(K11.TR, K11.C, generator=g, device=device)
    errs = {}
    for kind in K11.KINDS:
        errs[f"chain_{kind}"] = 0.0
        for reps in K11_REPS:
            got = K11.chain_probe(x, reps, kind)
            want = K11.chain_plain(x, reps, kind)
            err = (got - want).abs().max().item()
            ok = (err <= K11.fma_rtol(reps) * want.abs().max().item()
                  if kind == "fma" else same_bits(got, want))
            if not ok:
                raise AssertionError(f"K11 {kind} reps {reps}: kernel off "
                                     f"its plain version by {err:g}")
            errs[f"chain_{kind}"] = max(errs[f"chain_{kind}"], err)
    errs["copy_probe"] = 0.0
    for shape in (*K12_SHAPES, K12_RAGGED):
        a = torch.randn(shape, generator=g, device=device)
        if not same_bits(K12.copy_probe(a), K12.copy_plain(a)):
            raise AssertionError(f"K12 at {shape}: not bit for bit")
    # an offset view: unaligned, so the scalar kernel alone
    flat = torch.randn(K12_RAGGED[0] + 1, generator=g, device=device)
    view, o = flat[1:], torch.empty(K12_RAGGED, device=device)
    if K12.copy_split(view.data_ptr(), o.data_ptr(), view.numel()):
        raise AssertionError("K12: an offset view took the vector body")
    if not same_bits(K12.copy_probe(view, out=o), K12.copy_plain(view)):
        raise AssertionError("K12 on an offset view: not bit for bit")
    torch.cuda.synchronize()
    log(f"[probe] K11 vs plain max abs err {errs}; K12 bit for bit at "
        f"{(*K12_SHAPES, K12_RAGGED)} and on an offset view")
    return errs


def cli_expected(label, runs):
    """Exact launches of one CLI run, from the solves it ran
    (``benchmark.RUNS``): K1 one per two CG iterations plus the compute
    ceiling's, K2 the bootstrap and one per 16 passes; K5 each pass per
    BiCGStab iteration; PCG one y_dot per iteration; GMRES(10) one y per
    matvec, 11 per cycle and one closing residual per solve."""
    solves = {k: c for k, c in runs.items() if isinstance(k, int)}
    total = lambda f: sum(c * f(k) for k, c in solves.items())
    sfx = "3d" if label.endswith("3d") else ""
    if label == "cg 2d":
        return {"step2": total(lambda k: k // 2) + runs["step2_ceiling"],
                "gram2": total(lambda k: max(1, -(-(k // 2) // 16)))}
    if label == "bicgstab 2d":
        return {m: total(lambda k: k) for m in BICG_KERNELS}
    if label.startswith("pcg"):
        return {"y_dot" + sfx: total(lambda k: k)}
    return {"y" + sfx: total(lambda k: 11 * k + 1)}


def cli_path(torch, np, T, lt, device, card):
    """Phase 4h.  ``benchmark.main`` on each of CLI_RUNS with the stream
    bandwidth measured once, then ``probe_roofline.main``, each run
    between a reset and a read of the launch counters.  Returns (launches
    by counter over all runs, {run: main's dict}, probe results, the
    bandwidth passed)."""
    from legionsolvers_tpu_torch import benchmark
    from legionsolvers_tpu_torch.utils import probe_roofline, timing
    from legionsolvers_tpu_torch.utils import vpu_probe

    bw = timing.measure_stream_bandwidth(device=device)
    log(f"[cli] stream bandwidth (triad, 256 MB arrays) {bw / 1e9:.1f} GB/s "
        f"on {card}")
    # the CG run measures the op rates with K11 rather than reading them
    vpu_probe.cache_path(torch.cuda.get_device_name(0)).unlink(
        missing_ok=True)
    counts, results = {}, {}
    for label, argv in CLI_RUNS.items():
        T.reset_launch_counts()
        results[label] = benchmark.main(argv, bw=bw)
        torch.cuda.synchronize()
        got = dict(T.LAUNCHES)
        T.reset_launch_counts()
        want = cli_expected(label, benchmark.RUNS)
        body = {k: v for k, v in got.items() if not k.startswith("chain_")}
        if body != want:
            raise AssertionError(f"{label}: launches {got} != {want} "
                                 f"(solves {dict(benchmark.RUNS)})")
        if label == "cg 2d" and not all(
                got.get(f"chain_{k}", 0) for k in ("fma", "roll", "row")):
            raise AssertionError(f"cg 2d: K11 never launched: {got}")
        pct = results[label]["pct_roofline"]
        if pct is None or not 0 < pct <= 100:
            raise AssertionError(f"{label}: pct_roofline {pct}")
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        log(f"[cli] {label}: launches {got}")
    T.reset_launch_counts()
    probes = probe_roofline.main([])
    torch.cuda.synchronize()
    got = dict(T.LAUNCHES)
    T.reset_launch_counts()
    if set(got) != {"copy_probe"}:
        raise AssertionError(f"probe_roofline launches {got}")
    counts["copy_probe"] = got["copy_probe"]
    log(f"[cli] probe_roofline: launches {got}")
    return counts, results, probes, bw


def cli_checks(torch, np, lt, device):
    """Phase 4h's solution checks: PCG(Jacobi) at 4096^2 against float64
    CG as phase 4 holds f32 CG (no worse than twice textbook f32 CG); f32
    GMRES(10) at 4096^2 non-increasing within GMRES_SLACK and ||b - Ax||^2
    through ``planner.matvec`` within 1e-3 of its last entry; f64 GMRES
    and PCG at 256^2 on the card against the same solves on the CPU."""
    from legionsolvers_tpu_torch import benchmark

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    args = benchmark.make_parser().parse_args(CLI_2D)
    planner, _, _ = benchmark.build_planner(args, f32, device)
    h_pcg = lt.PCGSolver(planner, lt.JacobiPreconditioner(planner)).solve(
        N_ITERS)
    del planner
    h64, _ = classic_cg(torch, (N_GRID, N_GRID), N_ITERS, torch.float64,
                        device)
    h32, _ = classic_cg(torch, (N_GRID, N_GRID), N_ITERS, torch.float32,
                        device)
    dev_pcg, dev_32 = max_rel(h_pcg, h64), max_rel(h32, h64)
    if not dev_pcg <= 2 * dev_32:
        raise AssertionError(f"PCG(Jacobi) vs float64 CG {dev_pcg:g}, over "
                             f"twice textbook f32 CG's {dev_32:g}")
    log(f"[cli] PCG(Jacobi) solve({N_ITERS}) at {N_GRID}^2 vs float64 CG: "
        f"max rel {dev_pcg:.3g} (textbook f32 CG {dev_32:.3g})")

    planner, _, _ = benchmark.build_planner(args, f32, device)
    solver = lt.GMRESSolver(planner, 10)
    h = solver.solve(20).double()
    rise = (h[1:] / h[:-1]).max().item()
    if not rise <= 1 + GMRES_SLACK:
        raise AssertionError(f"f32 GMRES history rose by {rise - 1:g}")
    kb0 = solver.krylov_basis(0)
    planner.matvec(kb0, solver.SOL)
    b = planner.rhs_vectors[0].data
    res = torch.sum((b - planner.get_vector(kb0, 0).data).double() ** 2)
    gap = abs(res.item() - h[-1].item()) / h[-1].item()
    if gap > 1e-3:
        raise AssertionError(f"f32 GMRES ||b - Ax||^2 off its history by "
                             f"{gap:g}")
    log(f"[cli] f32 GMRES(10) x 20 at {N_GRID}^2: {h[0].item():.6g} -> "
        f"{h[-1].item():.6g}, largest rise {rise - 1:.3g}, ||b - Ax||^2 gap "
        f"{gap:.3g}")
    del planner, solver

    f64 = lt.SolverOptions(entry_dtype=torch.float64)
    devs = {}
    for name in ("gmres", "pcg"):
        hist, xs = [], []
        for d in (device, "cpu"):
            planner, _, _ = benchmark.build_planner(benchmark.make_parser(
            ).parse_args(["-dim", "2", "-nx", str(SMALL_GRID), "-ny",
                          str(SMALL_GRID)]), f64, d)
            if name == "gmres":
                hh = lt.GMRESSolver(planner, 10).solve(20)
            else:
                hh = lt.PCGSolver(planner, lt.JacobiPreconditioner(
                    planner)).solve(100)
            hist.append(hh.cpu().numpy())
            xs.append(planner.sol_vectors[0].to_numpy())
        devs[name] = (float(np.max(np.abs(hist[0] - hist[1]) /
                                   np.abs(hist[1]))),
                      float(np.max(np.abs(xs[0] - xs[1])) /
                            np.max(np.abs(xs[1]))))
        if max(devs[name]) > F64_CARD_RTOL:
            raise AssertionError(f"f64 {name} card vs CPU: {devs[name]}")
    log(f"[cli] f64 at {SMALL_GRID}^2, card vs CPU (history, x): {devs}")
    return {"pcg_vs_f64": (dev_pcg, dev_32), "gmres_rise": rise,
            "gmres_gap": gap, "f64_card_vs_cpu": devs}


def k12_turns(torch, x, y, rings):
    """CUDA-event ms of K12 ("k12") and ``torch.add(x, 1.0, out=y)``
    ("add") in turns: each ring runs k12, add, add, k12.  {name: [ms per
    turn]}."""
    from legionsolvers_tpu_torch.ops.cuda import copy_probe as K12

    fns = {"k12": lambda: K12.copy_probe(x, out=y),
           "add": lambda: torch.add(x, 1.0, out=y)}
    turns = {name: [] for name in fns}
    for _ in range(rings):
        for name in ("k12", "add", "add", "k12"):
            turns[name].append(event_ms(torch, fns[name], 20))
    return turns


def time_probes(torch, device, card):
    """Phase 5h, first part.  K12 at 16384 x 4096 (kernel, plain and
    ``torch.add(x, 1.0, out=y)``; the kernel and add in turns,
    :func:`k12_turns`), and K11's three kinds at K11_ROW_REPS trips
    (kernel and plain), CUDA events.  Returns ({row: (ms, plain ms,
    library ms)}, K12's bytes/s, {"k12" | "add": ms of each turn})."""
    from legionsolvers_tpu_torch.ops.cuda import copy_probe as K12
    from legionsolvers_tpu_torch.ops.cuda import vpu_probe as K11

    import statistics

    g = torch.Generator(device=device).manual_seed(72)
    x = torch.rand(K12_SHAPES[0], generator=g, device=device)
    y = torch.empty_like(x)
    turns = k12_turns(torch, x, y, K12_RINGS)
    med = {k: statistics.median(v) for k, v in turns.items()}
    out = {"copy_probe": (
        med["k12"], event_ms(torch, lambda: K12.copy_plain(x, out=y), 20),
        med["add"])}
    k12_bw = 8 * x.numel() / (out["copy_probe"][0] * 1e-3)
    span = lambda v: f"{min(v):.4f}-{max(v):.4f}"
    log(f"[time] K12 copy_probe median {med['k12']:.4f} ms (range "
        f"{span(turns['k12'])}; {k12_bw / 1e9:.1f} GB/s), torch.add median "
        f"{med['add']:.4f} ms (range {span(turns['add'])}), in turns over "
        f"{K12_RINGS} rings; plain {out['copy_probe'][1]:.4f} ms at "
        f"{K12_SHAPES[0]} on {card}")
    del x, y
    t = torch.randn(K11.TR, K11.C, generator=g, device=device)
    for kind in K11.KINDS:
        out[f"chain_{kind}"] = (
            event_ms(torch, lambda: K11.chain_probe(t, K11_ROW_REPS, kind), 5),
            event_ms(torch, lambda: K11.chain_plain(t, K11_ROW_REPS, kind), 1),
            None)
        log(f"[time] K11 {kind} at {K11_ROW_REPS} trips: kernel "
            f"{out[f'chain_{kind}'][0]:.4f} ms, plain "
            f"{out[f'chain_{kind}'][1]:.4f} ms on {card}")
    return out, k12_bw, turns


def time_rates(torch, device, card):
    """Phase 5h.  K11's three rates from CUDA events: (long - short) extra
    trips of UNROLL x ILP steps per element over the time they add."""
    from legionsolvers_tpu_torch.ops.cuda import vpu_probe as K11
    from legionsolvers_tpu_torch.utils import vpu_probe

    g = torch.Generator(device=device).manual_seed(73)
    t = torch.randn(K11.TR, K11.C, generator=g, device=device)
    rates = {}
    for kind, key in zip(K11.KINDS, vpu_probe.RATE_WINDOW):
        short, long = vpu_probe.CHAIN_LENGTHS[kind]
        ms = [event_ms(torch, lambda: K11.chain_probe(t, reps, kind), 3)
              for reps in (short, long)]
        steps = K11.UNROLL * K11.ILP * K11.TR * K11.C * (long - short)
        rates[key] = (2.0 if kind == "fma" else 1.0) * steps / (
            (ms[1] - ms[0]) * 1e-3)
    if not vpu_probe.rates_sane(rates):
        raise AssertionError(f"K11 rates outside the card's window: {rates}")
    log(f"[time] K11 rates (CUDA events): fma "
        f"{rates['vpu_fma_ops_per_s'] / 1e12:.2f} TFLOP/s, roll "
        f"{rates['vpu_roll_plus_add_reps_per_s'] / 1e9:.1f} G steps/s, row "
        f"{rates['vpu_row_shift_add_reps_per_s'] / 1e9:.1f} G steps/s on "
        f"{card}")
    return rates


def report_cli(torch, results, probes, device, bw, card):
    """Phase 5h, last part: the triads, the measured K1 compute ceiling
    and each CLI run's numbers."""
    from legionsolvers_tpu_torch.utils import timing

    per_elt, apparent, _ = timing.measure_step2_compute_ceiling(
        OFFS, VALS, device=device)
    resident = apparent > 1.5 * bw
    log(f"[time] triad 2^26 {probes['triad_2^26'] / 1e9:.1f} GB/s, 2^24 "
        f"{probes['triad_2^24'] / 1e9:.1f} GB/s, K12 (probe_roofline) "
        f"{probes['copy_k12'] / 1e9:.1f} GB/s; step2 ceiling "
        f"{per_elt * 1e12:.3f} ps/elt ({apparent / 1e9:.0f} GB/s apparent, "
        f"{'resident' if resident else 'not resident'}) on {card}")
    for label, r in results.items():
        log(f"[time] CLI {label}: {r['ms_per_iter']:.6f} ms/iter, "
            f"{r['gnnz_per_s']:.2f} Gnnz/s, {r['pct_roofline']:.1f}% of "
            f"{r['roofline_binding']} roofline ({r['schedule']}, "
            f"{r['bytes_per_unknown']:.2f} B/unknown) on {card}")
    return {"ceiling_ps_per_elt": per_elt * 1e12,
            "ceiling_apparent_GBps": apparent / 1e9,
            "ceiling_resident": resident}


def profile_cli(torch, lt, label, argv, card):
    """With --profile: the wall time and host enqueue time (until
    ``solve`` returns) of one CLI run's solve of its -it length, then its
    device time and idle share from :func:`profile_solve`."""
    from legionsolvers_tpu_torch import benchmark

    args = benchmark.make_parser().parse_args(argv)
    planner, _, _ = benchmark.build_planner(
        args, lt.SolverOptions(entry_dtype=torch.float32), "cuda")
    solver = benchmark.make_solver(args, planner)

    def once():
        restart(solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(args.it)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3

    once()
    wall, host = min(once() for _ in range(2))
    device_ms = profile_solve(torch, solver, f"cli_{label.replace(' ', '_')}",
                              card, wall, args.it)
    log(f"[profile] CLI {label} solve({args.it}): host enqueue {host:.3f} "
        f"ms of wall {wall:.3f} ms, on {card}")
    return device_ms, wall, host


# -- --solves and --ab: two trees of the package on the same card ------------

# the 3-D passes --solves times at 256^3: name -> compensated settings
AB_PASSES3 = {"xpay_pq3d": (False,), "bicg3d_st": (False, True),
              "bicg3d_update": (False, True)}


def time_ab_passes(torch, lt, device):
    """--solves: {"<pass> dim <d> compensated=<c>": {"events": ms,
    "graph": ms}} of AB_PASSES3 at 256^3, timed as :func:`time_3d_kernels`
    times them (CUDA events, and CUDA graphs, over a ring of three input
    sets, no halo planes)."""
    from legionsolvers_tpu_torch.ops.cuda import bicgstab3d as TB3
    from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3

    res = {}
    for dim in DIMS3:
        kw = stencil_kw(lt, dim)
        ring = [inputs3d(torch, SHAPE3, 50 + s, device) for s in range(3)]
        for d in ring:
            d["top"] = d["bot"] = None
            d["o1"] = torch.empty_like(d["x"])
        for name, comps in AB_PASSES3.items():
            for comp in comps:
                fns = [call3d(T3, TB3, name, d, kw, False, comp, out=d["o1"])
                       for d in ring]
                k = iter(range(10**9))
                res[f"{name} dim {dim} compensated={comp}"] = {
                    "events": event_ms(torch, lambda: fns[next(k) % 3](), 30),
                    "graph": graph_ms(torch, fns, 30)}
        del ring
    return res


def time_ab_passes_2d(torch, T, TB, device):
    """--solves and --passes: {"<K3 mode>" | "xpay_pq" | "bicg_st
    compensated=<c>" | "gram2" | "step2" | "<K3 mode or xpay_pq>
    <stencil>" | "bicg_pv <stencil>" | "bicg_st <stencil>" | "bicg_update
    <stencil>" | "gram2 <stencil>" | "gram2 coop <stencil>": {"events":
    ms, "graph": ms}}, K3, K4, K5b, K2 and K1 with the cross, K3, K4 and
    K5a-c with BAND_STENCILS and K5a-c with the cross and the 1-D view's
    decomposed Laplacian (``flat``; K5b also with compensated dots, and
    forced onto the band march, ``bicg_st flat band``), K2 on its route
    with S2_gen, S2_4x and S2_far and on its cooperative kernel with
    S2_gen and S2_far, at N_GRID^2, no halo blocks, f32 dots, timed as
    :func:`time_ab_passes` times the 3-D passes (CUDA events, and CUDA
    graphs, over a ring of three input sets; K3 update and K5c in place
    with a tiny alpha, K4 and K5c into a spare buffer, K1 and K5a into a
    spare pair, as phase 5a calls them); and "host_us <pass> <stencil>":
    {"host_us": the host's enqueue of one wrapper call, µs} for K5b with
    the cross and on the 1-D view."""
    g = torch.Generator(device=device).manual_seed(53)
    ring = [[torch.randn(N_GRID, N_GRID, generator=g, device=device)
             for _ in range(2)] for _ in range(3)]
    alpha = torch.tensor(0.83, device=device)
    cases = {f"bicg_st compensated={c}": [
        lambda a=a, b=b, c=c: TB.bicg_st(a, b, alpha, compensated=c, **KW)
        for a, b in ring] for c in (False, True)}
    forced = {}  # the cases timed with a route forced (forced_routes)
    cases["gram2"] = [lambda a=a, b=b: T.grid2d_cg_gram2(a, b, **KW)
                      for a, b in ring]
    ring1 = [make_inputs(torch, T, (N_GRID, N_GRID), 60 + s, device)
             for s in range(3)]
    for mode in (*ONE_PASS_NAMES, "step2"):
        cases[mode] = [kernel_call(T, mode, d, False) for d in ring1]
    for st in BAND_STENCILS:
        for mode in ONE_PASS_NAMES:
            cases[f"{mode} {st}"] = [kernel_call(T, mode, d, False,
                                                 band_kw(st, N_GRID))
                                     for d in ring1]
    ring5 = [bicg_inputs(torch, (N_GRID, N_GRID), 61 + s, device)
             for s in range(3)]
    for d in ring5:
        d["alpha"] = d["alpha"] * 1e-3  # K5c's x in place stays bounded
        d["p_out"], d["v_out"], d["r_out"] = (torch.empty_like(d["r"])
                                              for _ in range(3))
    for st, kw in (("cross", KW), ("flat", flat_kw(T, N_GRID)),
                   *((st, band_kw(st, N_GRID)) for st in BAND_STENCILS)):
        cases[f"bicg_pv {st}"] = [
            bicg_call(TB, "bicg_pv", d, False, False, (d["p_out"], d["v_out"]),
                      kw) for d in ring5]
        cases[f"bicg_update {st}"] = [
            bicg_call(TB, "bicg_update", d, False, False, d["r_out"], kw)
            for d in ring5]
        if st in BAND_STENCILS or st == "flat":
            cases[f"bicg_st {st}"] = [bicg_call(TB, "bicg_st", d, False,
                                                False, kw=kw) for d in ring5]
        if st == "flat":
            cases["bicg_st flat compensated=True"] = [
                bicg_call(TB, "bicg_st", d, True, False, kw=kw)
                for d in ring5]
            cases["bicg_st flat band"] = cases["bicg_st flat"]
            forced["bicg_st flat band"] = forced_routes(TB, ("st",),
                                                        kind="band")
    for st in ("S2_gen", "S2_4x", "S2_far"):
        kw = gen_kw(st, N_GRID)
        cases[f"gram2 {st}"] = [
            lambda d=d, kw=kw: T.grid2d_cg_gram2(d["r"], d["p"], **kw)
            for d in ring5]
        if st != "S2_4x":
            cases[f"gram2 coop {st}"] = cases[f"gram2 {st}"]
            forced[f"gram2 coop {st}"] = forced_routes(T, ("gram2",),
                                                   kind="general_coop")
    res = {}
    for name, fns in cases.items():
        k = iter(range(10**9))
        with forced.get(name, contextlib.nullcontext()):
            res[name] = {
                "events": event_ms(torch, lambda: fns[next(k) % 3](), 30),
                "graph": graph_ms(torch, fns, 30)}
    for st, kw in (("cross", KW), ("flat", flat_kw(T, N_GRID))):
        fn = bicg_call(TB, "bicg_st", ring5[0], False, False, kw=kw)
        res[f"host_us bicg_st {st}"] = {"host_us": host_us(torch, fn)}
    return res


def host_us(torch, fn, reps=200, rounds=3):
    """The host's enqueue of one call of ``fn``, µs: the best of
    ``rounds`` runs of ``reps`` calls, the device drained before each run
    and the clock stopped before it is drained again."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return best


# the solve(200)s of --solves, besides SOLVES3
SOLVES2 = ("cg2d", "cg2d_two_pass", "pcg2d", "bicg2d", "bicg2d_comp",
           "random")


def pcg_solver(lt, planner):
    """PCG with the Jacobi preconditioner, as the CLI's ``-solver 4``."""
    return lt.PCGSolver(planner, lt.JacobiPreconditioner(planner))


def solves(torch, np, T, lt, device, card, reps=5):
    """--solves: for the package this process imports, 2-D CG's distance
    from float64 at N_GRID and ACCURACY_GRIDS (:func:`cg2d_accuracy`);
    ``reps`` timed solve(200)s (:func:`solve_once`, after a warm-up) of the
    main path's 2-D CG at 4096^2 (s-step, and two-pass under
    LEGIONSOLVERS_NO_SSTEP), of 2-D PCG(Jacobi) and of 2-D BiCGStab at
    4096^2 with f32 and with compensated dots, of CG on the random 2^20
    system and of CG and BiCGStab on the 3-D 7- and 27-point systems at
    256^3 (SOLVES3); the host's enqueue time of one K10 call, per hop of one
    routed matvec (200 calls, no sync between them); the times of K3, K4,
    K5b and K2 at 4096^2 (:func:`time_ab_passes_2d`) and of AB_PASSES3
    (:func:`time_ab_passes`); and K12 and ``torch.add`` at 16384 x 4096 in
    turns over K12_SOLVES_RINGS rings (:func:`k12_turns`).  One JSON line."""
    from legionsolvers_tpu_torch.entry import build_stencil_system, build_system
    from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
    from legionsolvers_tpu_torch.ops.cuda import rowperm as RP

    out = {"card": card, "tree": os.getcwd(), "accuracy": {
        n: cg2d_accuracy(torch, T, lt, n, device)
        for n in (N_GRID, *ACCURACY_GRIDS)}}
    rsys = build_explicit(torch, np, lt, "random", device)
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    comp = lt.SolverOptions(entry_dtype=torch.float32, compensated_dots=True)
    runs_of = [("cg2d", lambda: lt.CGSolver(build_system(N_GRID, f32,
                                                         device))),
               ("cg2d_two_pass", lambda: lt.CGSolver(build_system(
                   N_GRID, f32, device))),
               ("pcg2d", lambda: pcg_solver(lt, build_system(N_GRID, f32,
                                                             device))),
               ("bicg2d", lambda: lt.BiCGStabSolver(build_system(
                   N_GRID, f32, device))),
               ("bicg2d_comp", lambda: lt.BiCGStabSolver(build_system(
                   N_GRID, comp, device))),
               ("random", lambda: lt.CGSolver(rsys["planner"]))]
    for name, (kind, dim) in SOLVES3.items():
        solver_cls = lt.CGSolver if kind == "cg" else lt.BiCGStabSolver
        runs_of.append((name, lambda c=solver_cls, d=dim: c(
            build_stencil_system(d, SHAPE3, f32, device))))
    for name, make in runs_of:
        solver = make()
        route = "LEGIONSOLVERS_NO_SSTEP" if name == "cg2d_two_pass" else None
        with env_route(route, solver):
            runs = [solve_once(torch, solver, N_ITERS)
                    for _ in range(reps + 1)][1:]
        out[name] = {"ms_per_iter": [d / N_ITERS for d, _ in runs],
                     "host_ms_per_iter": [h / N_ITERS for _, h in runs]}
        del solver
        torch.cuda.empty_cache()
    gop = rsys["planner"].row_partitioned_matrices[0][0].base
    hops = capture_hops(gop, torch.randn(gop.partition.padded_size,
                                         device=device))
    out["gather_hop_host_us"] = []
    for hop, src, idx, vals in hops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            RP.gather_hop(hop, src, idx, vals)
        out["gather_hop_host_us"].append(
            (time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    out["kernels2d_ms"] = time_ab_passes_2d(torch, T, TB, device)
    out["kernels3d_ms"] = time_ab_passes(torch, lt, device)
    x = torch.rand(K12_SHAPES[0], device=device)
    out["k12_turns_ms"] = k12_turns(torch, x, torch.empty_like(x),
                                    K12_SOLVES_RINGS)
    del x
    log(json.dumps(out))
    return 0


def ab_solves(parent, torch):
    """--ab PARENT: :func:`solves` on the package of the tree PARENT and
    on this script's own, alternating parent, change, change, parent, each
    in a process of its own.  Prints each run's JSON line and, last, the
    medians of each tree's pooled solves."""
    import statistics

    here = str(pathlib.Path(__file__).resolve().parent)
    trees = {"parent": os.path.abspath(parent), "change": here}
    runs = {"parent": [], "change": []}
    for label in ("parent", "change", "change", "parent"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--solves",
             "--tree", trees[label]],
            capture_output=True, text=True, timeout=1200)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-8000:])
            raise RuntimeError(f"--solves on {trees[label]} exited "
                               f"{proc.returncode}")
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {"card": card_line(), "kind": torch.cuda.get_device_name(0)}
    for label, rs in runs.items():
        pool = lambda f: [v for r in rs for v in f(r)]
        med = lambda f: statistics.median(pool(f))
        # 2-D CG's distance from float64 (the same in every run of a tree)
        summary[label] = {"accuracy": rs[0]["accuracy"]}
        summary[label].update({
            f"{name} {key}": med(lambda r: r[name][key])
            for name in (*SOLVES2, *SOLVES3)
            for key in ("ms_per_iter", "host_ms_per_iter")})
        summary[label].update({
            f"{name} ms_per_iter range": [
                f(pool(lambda r: r[name]["ms_per_iter"])) for f in (min, max)]
            for name in (*SOLVES2, *SOLVES3)})
        summary[label]["gather_hop_host_us"] = med(
            lambda r: r["gather_hop_host_us"])
        # each pass's [median, min, max] ms with events and in graphs
        for field in ("kernels2d_ms", "kernels3d_ms"):
            summary[label][field] = {
                f"{k} {how}": [med(lambda r: [r[field][k][how]]),
                               *(f(pool(lambda r: [r[field][k][how]]))
                                 for f in (min, max))]
                for k in rs[0][field] for how in ("events", "graph")}
        # K12 and torch.add: [median, min, max] ms over the turns
        summary[label]["k12_turns_ms"] = {
            k: [med(lambda r: r["k12_turns_ms"][k]),
                *(f(pool(lambda r: r["k12_turns_ms"][k])) for f in (min, max))]
            for k in ("k12", "add")}
    log(json.dumps(summary))
    return 0


# ---------------------------------------------------------------------------
# phase 4i: block systems (parallel/block_fused.py), 5i: their times
# ---------------------------------------------------------------------------

# name -> (-dim, grid, solver, environment switch or None): each block
# solve(200) beside the single-space solve(200) of the same system
BLOCK_RUNS = {
    "s-step CG 2-D": (2, (N_GRID, N_GRID), "CGSolver", None),
    "two-pass CG 2-D": (2, (N_GRID, N_GRID), "CGSolver",
                        "LEGIONSOLVERS_NO_SSTEP"),
    "BiCGStab 2-D": (2, (N_GRID, N_GRID), "BiCGStabSolver", None),
    "CG 3-D": (3, SHAPE3, "CGSolver", None),
    "BiCGStab 3-D": (3, SHAPE3, "BiCGStabSolver", None),
}
BLOCK_SPACES = 2
# launches of one single-space solve(200) of each run (the block solve
# launches each BLOCK_SPACES times as often)
BLOCK_SINGLE_LAUNCHES = {
    "s-step CG 2-D": {"step2": N_ITERS // 2, "gram2": 7},
    "two-pass CG 2-D": {"pq": 1, "update": N_ITERS, "xpay_pq": N_ITERS - 1},
    "BiCGStab 2-D": {m: N_ITERS for m in BICG_KERNELS},
    "CG 3-D": SOLVE3_LAUNCHES["cg"],
    "BiCGStab 3-D": SOLVE3_LAUNCHES["bicg"],
}
# the distinct-space runs: b0 = 1, b1 = 1 + BLOCK_EPS z, z standard normal
# from torch's generator seeded with BLOCK_SEED on the card
BLOCK_EPS = 0.01
BLOCK_SEED = 1
# bytes one single-space solve(200) of each run must move, per unknown: the
# s-step passes (24 B per two iterations) and 7 Gram passes (8 B); pq (4)
# and update (20), then 199 x (xpay_pq 12 + update 20); BiCGStab 60 B per
# iteration and the two bootstrap dots (16 B)
BLOCK_BYTES = {"s-step CG 2-D": 24 * 100 + 8 * 7,
               "two-pass CG 2-D": 24 + 32 * (N_ITERS - 1),
               "BiCGStab 2-D": 60 * N_ITERS + 16,
               "CG 3-D": 24 + 32 * (N_ITERS - 1),
               "BiCGStab 3-D": 60 * N_ITERS + 16}


class counted_calls:
    """Within the block, each function ``name`` of ``module`` for the
    (module, name) pairs given counts its calls in ``self.calls``, and the
    ``solvers``' cached runners (which hold the functions they were built
    with) are dropped on the way in and out.  A plain version run on the
    card launches none of our kernels, so the launch counters cannot see
    it; this can."""

    def __init__(self, pairs, *solvers):
        self.pairs, self.solvers = list(pairs), solvers
        self.calls = {}

    def __enter__(self):
        self.saved = [(m, k, getattr(m, k)) for m, k in self.pairs]
        for m, k, fn in self.saved:
            setattr(m, k, self._counted(k, fn))
        drop_runners(*self.solvers)
        return self

    def _counted(self, k, fn):
        def run(*a, **kw):
            self.calls[k] = self.calls.get(k, 0) + 1
            return fn(*a, **kw)
        return run

    def __exit__(self, *exc):
        for m, k, fn in self.saved:
            setattr(m, k, fn)
        drop_runners(*self.solvers)


def plain_names(*modules):
    """(module, name) of every plain version in the kernel modules."""
    return [(m, k) for m in modules for k in dir(m)
            if k.endswith("_plain") and callable(getattr(m, k))]


def block_classic_cg(torch, rhs, iters, dtype, matvec):
    """Textbook CG on diag(A, .., A), one right-hand side per space, x0 =
    0, every dot the sum of the per-space dots, in ``dtype``: (history,
    [x per space]), float64."""
    bs = [b.to(dtype) for b in rhs]
    xs, rs, ps = [b * 0 for b in bs], [b * 1 for b in bs], [b * 1 for b in bs]
    dot = lambda a, c: sum((u * v).sum() for u, v in zip(a, c))
    rr = dot(rs, rs)
    hist = [rr]
    for _ in range(iters):
        qs = [matvec(p) for p in ps]
        a = rr / dot(ps, qs)
        for x, r, p, q in zip(xs, rs, ps, qs):
            x += a * p
            r -= a * q
        rr_new = dot(rs, rs)
        hist.append(rr_new)
        ps = [r + (rr_new / rr) * p for r, p in zip(rs, ps)]
        rr = rr_new
    return torch.stack(hist).double(), [x.double() for x in xs]


def block_state(solver):
    """Every space's x, cloned."""
    planner = solver.planner
    return [planner.get_vector(solver.SOL, s).data.clone()
            for s in range(planner.num_spaces)]


def block_run(torch, T, solver, modules, iters=N_ITERS):
    """One solve(iters) from x0 = 0: (history, [x per space], launches,
    calls of a plain version, calls of ``cg2_coeffs``)."""
    with counted_calls(plain_names(*modules), solver) as plain, \
            counted_calls([(T, "cg2_coeffs")], solver) as coeffs:
        restart(solver)
        torch.cuda.synchronize()
        T.reset_launch_counts()
        hist = solver.solve(iters)
        torch.cuda.synchronize()
        counts = dict(T.LAUNCHES)
        T.reset_launch_counts()
    return (hist, block_state(solver), counts, sum(plain.calls.values()),
            coeffs.calls.get("cg2_coeffs", 0))


def block_path(torch, T, TB, T3, TB3, lt, device):
    """Phase 4i: every run of BLOCK_RUNS through ``entry.
    build_stencil_system(..., num_spaces=2)`` and the same system on one
    space.  Identical spaces (b = 1 in both): each space's x bit for bit
    the single-space x, the history exactly twice, the launches exactly
    twice, one ``cg2_coeffs`` per pass (not per space), no plain version
    called, and a repeat bit for bit.  Distinct spaces (b1 = 1 + 0.01 z) on
    the 2-D runs: CG's history and x no further from float64 block CG than
    twice textbook f32 block CG (phase 4's rule); BiCGStab against its
    eager step()s (rtol 1e-6 over the first N_AGREE entries) and ||b -
    Ax||^2 against the last history entry (5e-2), as phase 4b holds the
    single space.  Returns (launches by kernel name, with the 3-D ones
    keyed (name, 3), results, {run: (block solver, single solver)}, failed
    checks)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    modules = (T, TB, T3, TB3)
    launches, grid, results, solvers, checks = {}, {}, {}, {}, {}

    def add(counts, S):
        for m, n in counts.items():
            launches[m] = launches.get(m, 0) + n
            grid[m] = grid.get(m, 0.0) + n / S
    for name, (dim, grid, cls_name, env) in BLOCK_RUNS.items():
        cls = getattr(lt, cls_name)
        block = cls(build_stencil_system(dim, grid, f32, device,
                                         num_spaces=BLOCK_SPACES))
        single = cls(build_stencil_system(dim, grid, f32, device))
        solvers[name] = (block, single)
        with env_route(env, block, single):
            h1, (x1,), c1, p1, k1 = block_run(torch, T, single, modules)
            h2, xs, c2, p2, k2 = block_run(torch, T, block, modules)
            h3, xs3, c3, _, _ = block_run(torch, T, block, modules)
        want = BLOCK_SINGLE_LAUNCHES[name]
        twice = {m: BLOCK_SPACES * c for m, c in want.items()}
        res = {"launches single": c1, "launches block": c2,
               "cg2_coeffs single": k1, "cg2_coeffs block": k2,
               "plain calls": p1 + p2,
               "hist_last": (h1[-1].item(), h2[-1].item())}
        chk = {
            "launches exactly twice the single space's": c1 == want
            and c2 == twice and c3 == twice,
            "no plain version called": p1 + p2 == 0,
            "history exactly twice the single space's":
                same_bits(h2, 2 * h1),
            "every space's x bit for bit the single space's":
                all(same_bits(x, x1) for x in xs),
            "a repeat bit for bit": same_bits(h3, h2)
            and all(same_bits(a, b) for a, b in zip(xs3, xs)),
        }
        if "s-step" in name:
            chk["one cg2_coeffs per pass, as one space"] = k1 == k2 == \
                N_ITERS // 2
        if dim == 2:
            with env_route(env, block):
                res.update(block_distinct(torch, lt, block, cls_name, chk))
        for k, ok in chk.items():
            checks[f"{name}: {k}"] = ok
        res["checks"] = chk
        results[name] = res
        key = (lambda m: (m, 3)) if dim == 3 else (lambda m: m)
        for m, c in c2.items():
            launches[key(m)] = launches.get(key(m), 0) + c
        log(f"[block] {name}: launches single {c1}, block {c2}; cg2_coeffs "
            f"{k1} / {k2}; checks " + "; ".join(
                f"{k} {ok}" for k, ok in chk.items()))
    failed = [k for k, ok in checks.items() if not ok]
    log(f"[block] checks: {len(checks) - len(failed)} of {len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    return launches, results, solvers, failed


def block_distinct(torch, lt, solver, cls_name, chk):
    """The distinct-space checks of :func:`block_path` on the 2-D block
    ``solver`` (its rhs of space 1 is set to 1 + BLOCK_EPS z and back to
    1 after).  Adds its checks to ``chk``; returns its numbers."""
    planner = solver.planner
    rhs1 = planner.rhs_vectors[1].data
    g = torch.Generator(device=rhs1.device).manual_seed(BLOCK_SEED)
    rhs1.add_(BLOCK_EPS * torch.randn(rhs1.shape, generator=g,
                                      device=rhs1.device))
    rhs = [planner.rhs_vectors[s].data for s in range(BLOCK_SPACES)]
    res = {}
    try:
        if cls_name == "CGSolver":
            restart(solver)
            hist = solver.solve(N_ITERS)
            xs = block_state(solver)
            h64, x64 = block_classic_cg(torch, rhs, N_ITERS, torch.float64,
                                        lap5)
            h32, x32 = block_classic_cg(torch, rhs, N_ITERS, torch.float32,
                                        lap5)
            xd = lambda xv: max(x_rel(a, b) for a, b in zip(xv, x64))
            env = {"textbook f32": (max_rel(h32, h64), xd(x32)),
                   "kernel": (max_rel(hist, h64), xd(xs))}
            res["distinct vs float64 block CG (history, x)"] = env
            chk["distinct spaces: history and x within twice textbook f32 "
                "block CG's distance from float64"] = (
                env["kernel"][0] <= 2 * env["textbook f32"][0]
                and env["kernel"][1] <= 2 * env["textbook f32"][1])
            log(f"[block] distinct spaces against float64 block CG "
                f"(history, x): " + ", ".join(
                    f"{k} {h:.3g} {x:.3g}" for k, (h, x) in env.items()))
        else:
            restart(solver)
            eager = [solver.residual_norm_squared().value]
            for _ in range(N_AGREE - 1):
                solver.step()
                eager.append(solver.residual_norm_squared().value)
            eager = torch.stack(eager)
            restart(solver)
            hist = solver.solve(N_ITERS)
            planner.matvec(solver.U, solver.SOL)
            true_rr = sum(torch.sum((b - planner.get_vector(solver.U, s)
                                     .data).double() ** 2).item()
                          for s, b in enumerate(rhs))
            gap = abs(true_rr - hist[-1].item()) / hist[-1].item()
            dev = rel_dev(eager, hist[:N_AGREE]).max().item()
            res.update({"distinct eager vs fused": dev,
                        "distinct eager": eager.tolist(),
                        "distinct fused": hist[:N_AGREE].tolist(),
                        "distinct ||b-Ax||^2": true_rr,
                        "distinct history last": hist[-1].item(),
                        "distinct gap": gap})
            chk["distinct spaces: eager step() vs fused solve, first "
                "entries, rtol 1e-6"] = dev <= 1e-6
            chk["distinct spaces: ||b - Ax||^2 vs history[-1], rel "
                "5e-2"] = gap <= 5e-2
            log(f"[block] distinct spaces: eager vs fused rel dev "
                f"{dev:.3g} (eager {eager.tolist()}, fused "
                f"{hist[:N_AGREE].tolist()}); ||b-Ax||^2 {true_rr:.8g} vs "
                f"history "
                f"{hist[-1].item():.8g} (rel {gap:.3g})")
    finally:
        rhs1.fill_(1.0)
    return res


def time_block_solves(torch, solvers, bw, card):
    """Phase 5i.  For each block run, ms/iter and host enqueue ms/iter of
    the block solve(200) and of the single-space one (:func:`solve_ms`),
    and the block solve's idle share, 1 - device time over the wall, the
    device time from a torch.profiler trace (:func:`profile_solve`, run
    after all the timings).  {run: {...}}."""
    out = {}
    for name, (block, single) in solvers.items():
        dim, grid, _, env = BLOCK_RUNS[name]
        nbytes = BLOCK_BYTES[name] * math.prod(grid)
        with env_route(env, block, single):
            ms2, host2 = solve_ms(torch, block, N_ITERS)
            ms1, host1 = solve_ms(torch, single, N_ITERS)
        sane(f"block {name} solve", ms2, BLOCK_SPACES * nbytes, bw)
        sane(f"{name} solve", ms1, nbytes, bw)
        out[name] = {"block ms/iter": ms2 / N_ITERS,
                     "single ms/iter": ms1 / N_ITERS,
                     "block host ms/iter": host2 / N_ITERS,
                     "single host ms/iter": host1 / N_ITERS}
    for name, (block, _) in solvers.items():
        row = out[name]
        with env_route(BLOCK_RUNS[name][3], block):
            dev = profile_solve(torch, block,
                                "block_" + name.replace(" ", "_"), card,
                                row["block ms/iter"] * N_ITERS)
        row["block device ms/iter"] = dev / N_ITERS
        row["block idle"] = 1 - row["block device ms/iter"] \
            / row["block ms/iter"]
        log(f"[time] block {name} solve({N_ITERS}): {row['block ms/iter']:.4f}"
            f" ms/iter (twice one space: "
            f"{2 * row['single ms/iter']:.4f}); host enqueue "
            f"{row['block host ms/iter']:.4f} (one space "
            f"{row['single host ms/iter']:.4f}); device "
            f"{row['block device ms/iter']:.4f}, idle "
            f"{100 * row['block idle']:.1f}% on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 4j: pieces on one card (parallel/mesh.py, overlap.py,
# sstep_sharded.py), 5j: their times
# ---------------------------------------------------------------------------

# name -> (pieces, environment switch or None): each solve(200) of the 2-D
# system at 4096^2 on a mesh of that many shards, all on the card
PIECE_RUNS = {
    "s-step CG, 4 pieces": (4, None),
    "s-step CG, 8 pieces": (8, None),
    "two-pass CG, 4 pieces": (4, "LEGIONSOLVERS_NO_SSTEP"),
}
# launches of one solve(200) on one piece (each kernel runs once per piece)
PIECE_ONE_LAUNCHES = {
    None: {"step2": N_ITERS // 2, "gram2": 7},
    "LEGIONSOLVERS_NO_SSTEP": {"pq": 1, "update": N_ITERS,
                               "xpay_pq": N_ITERS - 1},
}
PIECE_SEED = 3
# the CLI runs of phase 4j (-vp 4) iterate half of N_ITERS: they are
# host-bound, and their checks (report, schedule, exact launches) do not
# turn on the length
PIECE_CLI_ITERS = N_ITERS // 5
PIECE_CLI = ["-dim", "2", "-nx", str(N_GRID), "-ny", str(N_GRID),
             "-solver", "1", "-it", str(PIECE_CLI_ITERS), "-vp", "4"]


class glue_ops:
    """Within the block, counts the torch operations that run on tensors
    of ``device_type`` and launch work there (views and allocations
    excluded): the glue between our kernels, whose ctypes launches torch
    never sees.  A host-side count, exact where a profiler trace may drop
    events."""

    NO_LAUNCH = {"empty", "empty_like", "empty_strided", "new_empty",
                 "new_empty_strided", "detach", "alias", "lift_fresh",
                 "_local_scalar_dense", "is_nonzero", "equal"}

    def __init__(self, device_type="cuda"):
        self.device_type = device_type

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__
                if not (func.is_view or name in glue_ops.NO_LAUNCH):
                    flat = [a for a in (*args, *(kwargs or {}).values(),
                                        out) if isinstance(a, torch.Tensor)]
                    flat += [t for a in (*args, out) if isinstance(
                        a, (list, tuple)) for t in a
                        if isinstance(t, torch.Tensor)]
                    if any(t.device.type == counter.device_type
                           for t in flat):
                        counter.ops[name] = counter.ops.get(name, 0) + 1
                return out

        self.ops = {}
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)

    @property
    def total(self):
        return sum(self.ops.values())


# the wrappers that the solves on pieces call, by module, and the launch
# each counts (the matvecs: y or y_dot, y3d or y_dot3d)
SHADOW_LAUNCH = {"grid2d_stencil_matvec": None, "grid2d_cg_pq": "pq",
                 "grid2d_cg_update": "update", "grid2d_cg_xpay_pq": "xpay_pq",
                 "grid2d_cg_gram2": "gram2", "grid2d_cg_step2": "step2"}
SHADOW_BICG = {"bicg_pv": "bicg_pv", "bicg_st": "bicg_st",
               "bicg_update": "bicg_update"}
SHADOW_3D = {"grid3d_stencil_matvec": None, "grid3d_cg_pq": "pq3d",
             "grid3d_cg_update": "update3d", "grid3d_cg_xpay_pq": "xpay_pq3d"}


def finite_max(t):
    """max |t| over its finite entries (0 where there is none), 0-dim."""
    import torch

    a = t.abs()
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a)).max()


def matvec3d_plain(T3):
    return lambda x, top=None, bot=None, *, with_dot=False, out=None, **kw: (
        T3.stencil3d_plain("y_dot", x, top, bot, out=out, **kw) if with_dot
        else T3.stencil3d_plain("y", x, top, bot, out=out, **kw)[0])


class shadowed:
    """Within the block, every call of a wrapper that the solves on pieces
    call (K1-K4 of ``T``; K5a-c of ``TB`` and K6a, K6b of ``T3`` where
    given) also runs the wrapper's plain version on copies of its inputs,
    taken before the kernel writes, and holds the kernel's outputs to it
    at phase 3's bounds: each array elementwise to 1e-5 of the plain
    version's max |value|, each dot to 1e-4 of sqrt(<a,a><b,b>) of its
    operands.  ``calls``: {launch name: calls held}; ``worst``: {launch
    name: max abs error}; ``share``: {launch name: the largest error as a
    share of its bound}; ``bad``: the calls out of bounds.  The
    ``solver``'s cached runners are dropped on the way in and out."""

    def __init__(self, T, solver=None, TB=None, T3=None):
        self.T, self.solver, self.TB, self.T3 = T, solver, TB, T3
        self.calls, self.worst, self.share, self.bad = {}, {}, {}, []

    def __enter__(self):
        plain = cg_plain(self.T)
        table = [(self.T, k, mode, plain[k])
                 for k, mode in SHADOW_LAUNCH.items()]
        if self.TB is not None:
            table += [(self.TB, k, mode, getattr(self.TB, k + "_plain"))
                      for k, mode in SHADOW_BICG.items()]
        if self.T3 is not None:
            plain3 = dict(cg3d_plain(self.T3),
                          grid3d_stencil_matvec=matvec3d_plain(self.T3))
            table += [(self.T3, k, mode, plain3[k])
                      for k, mode in SHADOW_3D.items()]
        self.saved = [(m, k, getattr(m, k)) for m, k, _, _ in table]
        for m, k, mode, fn in table:
            setattr(m, k, self._wrap(k, mode, getattr(m, k), fn))
        if self.solver is not None:
            drop_runners(self.solver)
        return self

    def __exit__(self, *exc):
        for m, k, fn in self.saved:
            setattr(m, k, fn)
        if self.solver is not None:
            drop_runners(self.solver)

    def _wrap(self, name, mode, kernel, plain):
        import torch

        copy = lambda a: a.clone() if isinstance(a, torch.Tensor) else a

        def run(*args, **kw):
            cargs = [copy(a) for a in args]
            ckw = {k: copy(v) for k, v in kw.items() if k != "out"}
            got = kernel(*args, **kw)
            self._check(name, mode, got, plain(*cargs, **ckw), cargs, ckw)
            return got
        return run

    def _spec(self, name, mode, got, ref, args, kw):
        """(launch name, got, ref, keys, {dot key: its operands' scale},
        {array key: the magnitude of the terms it sums})."""
        import torch

        nrm = lambda v: torch.linalg.vector_norm(v.double()).item()
        T, T3 = self.T, self.T3
        arg = lambda i, key: args[i] if len(args) > i else kw.get(key)
        A = lambda v, top=None, bot=None: T.apply_plain(
            v, kw["offsets"], kw["values"], top, bot)
        A3 = lambda v, top=None, bot=None: T3.apply_planes_plain(
            v, kw["offsets"], kw["values"], top, bot)
        if mode is None:  # a matvec, 2-D or 3-D
            mode = ("y_dot" if kw.get("with_dot") else "y") + (
                "3d" if name.startswith("grid3d") else "")
            if not kw.get("with_dot"):
                got, ref = (got,), (ref,)
            keys = ("y", "dot")
            return mode, got, ref, keys, {
                "dot": lambda r: nrm(args[0]) * nrm(r["y"])}, {}
        if mode in ("pq", "pq3d"):
            ap = A if mode == "pq" else A3
            return mode, (got,), (ref,), ("dot",), {
                "dot": lambda r: nrm(args[0]) * nrm(ap(
                    args[0], arg(1, "halo_top"), arg(2, "halo_bot")))}, {}
        if mode in ("update", "update3d"):
            return mode, got, ref, ("x", "r", "dot"), {
                "dot": lambda r: nrm(r["r"]) ** 2}, {}
        if mode == "xpay_pq":
            comb = lambda rh, ph: (None if rh is None and ph is None else
                                   (0 if rh is None else rh) + args[2]
                                   * (0 if ph is None else ph))
            return mode, got, ref, ("p", "dot"), {
                "dot": lambda r: nrm(r["p"]) * nrm(A(
                    r["p"], comb(arg(3, "r_top"), arg(5, "p_top")),
                    comb(arg(4, "r_bot"), arg(6, "p_bot"))))}, {}
        if mode == "xpay_pq3d":
            return mode, got, ref, ("p", "dot"), {
                "dot": lambda r: nrm(r["p"]) * nrm(A3(
                    r["p"], arg(3, "pn_top"), arg(4, "pn_bot")))}, {}
        if mode == "gram2":
            return mode, (got,), (ref,), ("gram",), {
                "gram": lambda r: gram_scales(torch, T, args[0], args[1],
                                              kw)}, {}
        if mode == "step2":
            return mode, got, ref, ("x", "r", "p", "gram"), {
                "gram": lambda r: gram_scales(torch, T, r["r"], r["p"],
                                              kw)}, {}
        # the BiCGStab passes' arrays: near a breakdown their terms cancel,
        # so a value may be far smaller than the terms both versions round;
        # each array is held to the magnitude of its terms (no smaller
        # than its own max |value|)
        mag = lambda t: finite_max(t)
        co = lambda c: torch.as_tensor(c).to(args[0]).abs()
        stencil = sum(abs(v) for v in kw["values"])
        if mode == "bicg_pv":
            r_, p_, v_, _, b_, o_ = args[:6]
            sp = mag(r_) + co(b_) * (mag(p_) + co(o_) * mag(v_))
            return mode, got, ref, ("p", "v", "rtv"), {
                "rtv": lambda r: nrm(args[3]) * nrm(r["v"])}, {
                "p": sp, "v": stencil * sp}
        if mode == "bicg_st":
            r_, v_, al = args[:3]
            s_ = r_ - torch.as_tensor(al).to(r_) * v_
            t_ = A(s_)
            return mode, got, ref, ("ts", "tt"), {
                "ts": lambda r: nrm(t_) * nrm(s_),
                "tt": lambda r: nrm(t_) ** 2}, {}
        r_, v_, x_, p_, _, al, om = args[:7]
        ss = mag(r_) + co(al) * mag(v_)
        return mode, got, ref, ("x", "r", "rr", "rtr"), {
            "rr": lambda r: nrm(r["r"]) ** 2,
            "rtr": lambda r: nrm(args[4]) * nrm(r["r"])}, {
            "x": mag(x_) + co(al) * mag(p_) + co(om) * ss,
            "r": ss * (1 + co(om) * stencil)}

    def _check(self, name, mode, got, ref, args, kw):
        import torch

        mode, got, ref, keys, scales, terms = self._spec(name, mode, got,
                                                         ref, args, kw)
        got, ref = dict(zip(keys, got)), dict(zip(keys, ref))
        worst = share = 0.0
        for key, want in ref.items():
            # on the card: only scalars come back to the host
            have = got[key].double()
            err = (have - want.double()).abs()
            if key in scales:
                bound = 1e-4 * torch.as_tensor(
                    scales[key](ref), dtype=torch.float64).to(err.device)
            else:
                bound = 1e-5 * torch.maximum(
                    finite_max(want), torch.as_tensor(
                        terms.get(key, 0.0)).to(err.device)).double()
            # a NaN or infinity both versions give at one place agrees
            same = (have == want.double()) | (have.isnan() & want.isnan())
            err = torch.where(same, torch.zeros_like(err), err)
            ok = bool((same | (err <= bound)).all())
            ratio = torch.where(err == 0, torch.zeros_like(err), err / bound)
            worst = max(worst, err.max().item())
            share = max(share, ratio.max().item())
            if not ok:
                self.bad.append((mode, key, err.max().item()))
        self.calls[mode] = self.calls.get(mode, 0) + 1
        self.worst[mode] = max(self.worst.get(mode, 0.0), worst)
        self.share[mode] = max(self.share.get(mode, 0.0), share)


def pieces_path(torch, np, T, TB, T3, TB3, lt, device):
    """Phase 4j: the 2-D 5-point Laplacian at 4096^2, f32, b = 1, x0 = 0,
    through ``entry.build_system(..., mesh=make_mesh(S, devices=[card] *
    S))``.  The matvec at S = 4 and 8 against one piece on one random x,
    within 4 eps max|x| sum|v_k| (one K3 ``y`` per piece).  Each run of
    PIECE_RUNS: solve(200) with its launches exactly S times one piece's,
    ``cg2_coeffs`` as often as on one piece (one per pass), no plain
    version called, the history and x within twice textbook f32 CG's
    distance from float64 CG (phase 4's rule), a repeat bit for bit, and
    the distance from the one-piece solve reported.  Then the CLI's
    ``-dim 2 -solver 1 -vp 4`` (its launches exactly 4x one piece's per
    solve plus the compute ceiling's).  The matvec and each solve are also
    run under :class:`shadowed`, every launch held to its plain version on
    the same inputs, and each solve driven by the plain versions (its
    twin).  Returns (launches by kernel name, the same in whole-grid
    launches (a launch on one of S pieces counts 1/S), results, {run:
    (solver, one-piece solver)}, failed checks); the CLI's launches stay in
    the results."""
    from legionsolvers_tpu_torch import benchmark
    from legionsolvers_tpu_torch.entry import build_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    modules = (T, TB, T3, TB3)
    mesh = lambda S: make_mesh(S, devices=[device] * S)
    launches, grid, results, solvers, checks = {}, {}, {}, {}, {}

    def add(counts, S):
        for m, n in counts.items():
            launches[m] = launches.get(m, 0) + n
            grid[m] = grid.get(m, 0.0) + n / S

    # the matvec on pieces against one piece
    one = build_system(N_GRID, f32, device)
    gen = torch.Generator(device).manual_seed(PIECE_SEED)
    x = torch.rand((N_GRID, N_GRID), generator=gen, device=device)
    y1 = one.row_partitioned_matrices[0][0].matvec(x)
    bound = 4 * torch.finfo(torch.float32).eps * x.abs().max().item() * sum(
        abs(v) for v in VALS)
    for S in (4, 8):
        op = build_system(N_GRID, f32, mesh=mesh(S)).row_partitioned_matrices[
            0][0]
        torch.cuda.synchronize()
        T.reset_launch_counts()
        yS = op.matvec(x)
        torch.cuda.synchronize()
        got = dict(T.LAUNCHES)
        T.reset_launch_counts()
        err = (yS - y1).abs().max().item()
        checks[f"matvec on {S} pieces within {bound:.3g} of one piece"] = (
            err <= bound and got == {"y": S})
        add(got, S)
        with shadowed(T) as sh:
            op.matvec(x)
        torch.cuda.synchronize()
        T.reset_launch_counts()
        checks[f"matvec on {S} pieces: each K3 y equals its plain version "
               "on the same inputs"] = not sh.bad and sh.calls == {"y": S}
        results[f"matvec {S} pieces"] = {
            "max_abs_err": err, "bound": bound, "launches": got,
            "kernel vs plain": sh.worst, "share of bound": sh.share,
            "out of bounds": sh.bad}
        log(f"[pieces] matvec on {S} pieces: max |y_S - y_1| {err:.3g} "
            f"(bound {bound:.3g}); launches {got}; each launch against its "
            f"plain version: max abs err {sh.worst}, share of bound "
            f"{sh.share}, out of bounds {sh.bad}")
        del op, yS
    del x, y1

    h64, x64 = classic_cg(torch, (N_GRID, N_GRID), N_ITERS, torch.float64,
                          device)
    h32, x32 = classic_cg(torch, (N_GRID, N_GRID), N_ITERS, torch.float32,
                          device)
    textbook = (max_rel(h32, h64), x_rel(x32, x64))
    del x32
    single = lt.CGSolver(one)
    one_twin = {}
    for name, (S, env) in PIECE_RUNS.items():
        solver = lt.CGSolver(build_system(N_GRID, f32, mesh=mesh(S)))
        solvers[name] = (solver, single)
        with env_route(env, solver, single):
            h1, (x1,), c1, p1, k1 = block_run(torch, T, single, modules)
            h, (xs,), c, p, k = block_run(torch, T, solver, modules)
            h2, (xs2,), c2, _, _ = block_run(torch, T, solver, modules)
        with env_route(env, solver), shadowed(T, solver) as sh:
            restart(solver)
            solver.solve(N_ITERS)
            torch.cuda.synchronize()
        T.reset_launch_counts()
        with env_route(env, solver), plain_driven(T, solver, cg_plain(T)):
            hp, (xp,), cp, _, _ = block_run(torch, T, solver, modules)
        if env not in one_twin:
            with env_route(env, single), plain_driven(T, single,
                                                      cg_plain(T)):
                ho, (xo,), _, _, _ = block_run(torch, T, single, modules)
            one_twin[env] = (max_rel(ho, h64), x_rel(xo, x64))
            del xo
        want = {m: S * n for m, n in PIECE_ONE_LAUNCHES[env].items()}
        env_f64 = (max_rel(h, h64), x_rel(xs, x64))
        twin_f64 = (max_rel(hp, h64), x_rel(xp, x64))
        res = {"launches": c, "launches one piece": c1,
               "cg2_coeffs": k, "cg2_coeffs one piece": k1,
               "plain calls": p + p1, "vs_f64": env_f64,
               "vs_f64 textbook f32": textbook,
               "vs one piece": (max_rel(h, h1), x_rel(xs, x1)),
               "kernel vs plain per launch": sh.worst,
               "share of bound per launch": sh.share,
               "out of bounds": sh.bad, "twin vs_f64": twin_f64,
               "one-piece twin vs_f64": one_twin[env],
               "vs plain-driven twin": (max_rel(h, hp), x_rel(xs, xp)),
               "hist_last": (h[-1].item(), h1[-1].item())}
        chk = {
            f"launches exactly {want}": c == want == c2
            and c1 == PIECE_ONE_LAUNCHES[env],
            "cg2_coeffs as often as one piece": k == k1,
            "no plain version called": p + p1 == 0,
            "history and x within twice textbook f32's distance from "
            "float64": bool(torch.isfinite(h).all())
            and env_f64[0] <= 2 * textbook[0]
            and env_f64[1] <= 2 * textbook[1],
            "a repeat bit for bit": same_bits(h2, h) and same_bits(xs2, xs),
            "every launch equals its plain version on the same inputs "
            "(phase 3's bounds)": not sh.bad and sh.calls == want,
            "the plain-driven twin launches no kernel": cp == {}
            and bool(torch.isfinite(hp).all()),
        }
        for kk, ok in chk.items():
            checks[f"{name}: {kk}"] = ok
        res["checks"] = chk
        results[name] = res
        add(c, S)
        log(f"[pieces] {name}: launches {c} (one piece {c1}); cg2_coeffs "
            f"{k} / {k1}; against float64 CG (history, x) "
            f"{env_f64[0]:.3g} {env_f64[1]:.3g} (textbook f32 "
            f"{textbook[0]:.3g} {textbook[1]:.3g}; plain-driven twin "
            f"{twin_f64[0]:.3g} {twin_f64[1]:.3g}; one piece's twin "
            f"{one_twin[env][0]:.3g} {one_twin[env][1]:.3g}); against one "
            f"piece "
            f"{res['vs one piece'][0]:.3g} {res['vs one piece'][1]:.3g}; "
            f"against the twin {res['vs plain-driven twin'][0]:.3g} "
            f"{res['vs plain-driven twin'][1]:.3g}; each launch against its "
            f"plain version: max abs err {sh.worst}, share of bound "
            f"{sh.share}; checks "
            + "; ".join(f"{kk} {ok}" for kk, ok in chk.items()))
        del xs, xs2, x1, xp

    # the CLI on 4 pieces
    T.reset_launch_counts()
    out = benchmark.main(PIECE_CLI, bw=copy_bandwidth(torch, device))
    torch.cuda.synchronize()
    got = {m: n for m, n in T.LAUNCHES.items() if not m.startswith("chain_")}
    T.reset_launch_counts()
    runs = benchmark.RUNS
    solves = {kk: n for kk, n in runs.items() if isinstance(kk, int)}
    want = {"step2": 4 * sum(n * (kk // 2) for kk, n in solves.items())
            + runs["step2_ceiling"],
            "gram2": 4 * sum(n * max(1, -(-(kk // 2) // 16))
                             for kk, n in solves.items())}
    checks["the CLI's -vp 4: report, schedule and launches"] = (
        out["pieces"] == 4 and out["schedule"] == "fused2d_x2"
        and math.isfinite(out["final_residual2"]) and got == want)
    results["cli -vp 4"] = {k: out[k] for k in (
        "ms_per_iter", "gnnz_per_s", "pct_roofline", "final_residual2",
        "schedule")}
    results["cli -vp 4"]["launches"] = got
    log(f"[pieces] CLI -vp 4: {results['cli -vp 4']}; launches {got} "
        f"(expected {want})")
    failed = [kk for kk, ok in checks.items() if not ok]
    log(f"[pieces] checks: {len(checks) - len(failed)} of {len(checks)} "
        "hold" + (f"; FAILED: {failed}" if failed else ""))
    return launches, grid, results, solvers, failed


def time_piece_solves(torch, solvers, bw, card):
    """Phase 5j, the timings: for each run of PIECE_RUNS, ms/iter (CUDA
    events, the better of two solve(200)s after a warm-up) and host enqueue
    ms/iter of the solve on pieces and of the one-piece solve in the same
    process, and the torch glue operations per pass (a K1 pass of two
    iterations, or one two-pass iteration) counted on the host
    (:class:`glue_ops`).  {run: {...}}."""
    out = {}
    nbytes = {None: (24 * (N_ITERS // 2) + 8 * 7) * N_GRID * N_GRID,
              "LEGIONSOLVERS_NO_SSTEP": (24 + 32 * (N_ITERS - 1))
              * N_GRID * N_GRID}
    for name, (solver, single) in solvers.items():
        S, env = PIECE_RUNS[name]
        row = {}
        with env_route(env, solver, single):
            for label, slv in (("pieces", solver), ("one piece", single)):
                ms, host = solve_ms(torch, slv, N_ITERS)
                sane(f"{name} {label} solve", ms, nbytes[env], bw)
                restart(slv)
                torch.cuda.synchronize()
                with glue_ops() as glue:
                    slv.solve(N_ITERS)
                torch.cuda.synchronize()
                per = N_ITERS // 2 if env is None else N_ITERS
                row[label] = {"ms/iter": ms / N_ITERS,
                              "host ms/iter": host / N_ITERS,
                              "glue ops per pass": glue.total / per,
                              "glue ops by name": glue.ops}
        out[name] = row
        log(f"[time] {name} solve({N_ITERS}): "
            + "; ".join(f"{lab} {r['ms/iter']:.4f} ms/iter, host enqueue "
                        f"{r['host ms/iter']:.4f}, "
                        f"{r['glue ops per pass']:.2f} torch glue ops per "
                        f"pass" for lab, r in row.items()) + f" on {card}")
    return out


def wrapper_host_us(torch, T, device, card, reps=200, rounds=3):
    """Phase 5j: the host's enqueue time, in µs, of one call of each
    wrapper that the solves on pieces call per piece (K1, K4, K3 update),
    on one piece of 4 (1024 x 4096 rows) and on the whole 4096^2 grid:
    ``reps`` calls back to back on the host clock until the last returns
    (the card runs behind; its queue does not fill), the least of
    ``rounds`` such runs.  {wrapper: {"piece": µs, "whole": µs}}."""
    out = {}
    gen = torch.Generator(device).manual_seed(PIECE_SEED)
    for label, rows in (("piece", N_GRID // 4), ("whole", N_GRID)):
        x, r, p, o1, o2 = (torch.rand((rows, N_GRID), generator=gen,
                                      device=device) for _ in range(5))
        coef = T.cg2_coeffs(T.grid2d_cg_gram2(r, p, **KW))[0]
        beta = torch.tensor(0.5, device=device)
        alpha = torch.tensor(1e-3, device=device)
        fns = {"step2": lambda: T.grid2d_cg_step2(x, r, p, coef,
                                                  out=(o1, o2), **KW),
               "xpay_pq": lambda: T.grid2d_cg_xpay_pq(r, p, beta, out=o1,
                                                      **KW),
               "update": lambda: T.grid2d_cg_update(p, x, r, alpha, **KW)}
        for name, fn in fns.items():
            out.setdefault(name, {})[label] = host_us(torch, fn, reps, rounds)
        del x, r, p, o1, o2
    log("[time] host enqueue per wrapper call, µs (one piece of 4; whole "
        "4096^2): " + "; ".join(f"{k} {v['piece']:.1f}, {v['whole']:.1f}"
                                for k, v in out.items()) + f" on {card}")
    return out


def glue_host_us(times, wrappers):
    """The host µs per torch glue operation that the enqueue times imply:
    (host µs per pass - the wrapper calls' µs) / glue operations per pass,
    for each solve on pieces and on one piece."""
    calls = {None: ("step2",), "LEGIONSOLVERS_NO_SSTEP": ("xpay_pq",
                                                          "update")}
    per_pass = {None: 2, "LEGIONSOLVERS_NO_SSTEP": 1}
    for name, row in times.items():
        S, env = PIECE_RUNS[name]
        for label, pieces in (("pieces", S), ("one piece", 1)):
            r = row[label]
            host_us = r["host ms/iter"] * per_pass[env] * 1e3
            key = "piece" if pieces > 1 else "whole"
            wrap_us = pieces * sum(wrappers[c][key] for c in calls[env])
            r["host µs per glue op"] = ((host_us - wrap_us)
                                        / r["glue ops per pass"])
    log("[time] implied host µs per torch glue operation: " + "; ".join(
        f"{name}: pieces {row['pieces']['host µs per glue op']:.2f}, one "
        f"piece {row['one piece']['host µs per glue op']:.2f}"
        for name, row in times.items()))
    return times


def profile_piece_solves(torch, solvers, times, card):
    """Phase 5j, the traces (after every timing: the tracer slows later
    launches): each solve's idle share, 1 - profiler device time per
    iteration over the unprofiled wall's of :func:`time_piece_solves`, on
    pieces and on one piece, each traced over about TRACE_OPS glue
    operations (at least 1 / TRACE_SHARE of the timed iterations; an even
    count on the s-step schedule), as :func:`profile_piece_solvers`
    traces."""
    for name, (solver, single) in solvers.items():
        env = PIECE_RUNS[name][1]
        for label, slv in (("pieces", solver), ("one piece", single)):
            row = times[name][label]
            per_iter = row["glue ops per pass"] / (2 if env is None else 1)
            n = min(N_ITERS, max(1, N_ITERS // TRACE_SHARE, round(
                TRACE_OPS / max(per_iter, 1))))
            if env is None:
                n += n % 2
            row["traced iterations"] = n
            with env_route(env, slv):
                dev = profile_solve(
                    torch, slv, "pieces_" + name.replace(" ", "_").replace(
                        ",", "") + ("" if label == "pieces" else "_one"),
                    card, row["ms/iter"] * n, n)
            row["device ms/iter"] = dev / n
            row["idle"] = 1 - row["device ms/iter"] / row["ms/iter"]
        log(f"[time] {name}: idle " + "; ".join(
            f"{lab} {100 * r['idle']:.1f}% (device {r['device ms/iter']:.4f}"
            f" ms/iter over {r['traced iterations']} traced)"
            for lab, r in times[name].items()) + f" on {card}")
    return times


# phase 4j, the solves on pieces beyond 2-D CG: 3-D stencils on pieces
# (K6 with the neighbours' halo planes), the fused 2-D BiCGStab on pieces
# (K5a-c zero-halo with its edge fix-ups), BiCGStab step() on 3-D pieces,
# GMRES and PCG on 2-D pieces, block systems on pieces and the CLI's -vp
PIECES = 4
# 4j's 3-D CG and block systems on pieces run half as long as the other
# solves: their checks do not turn on the length, and the phase is
# host-bound
PIECE_ITERS = N_ITERS // 2
PIECE3_ONE = {"pq3d": 1, "update3d": PIECE_ITERS,
              "xpay_pq3d": PIECE_ITERS - 1}
PIECE3_LAUNCHES = {m: PIECES * k for m, k in PIECE3_ONE.items()}
PIECE_BICG_LAUNCHES = {m: PIECES * N_ITERS for m in BICG_KERNELS}
BICG3_STEP_ITERS = 50
TRACE_OPS = 1000  # glue operations a 5j or 5k idle trace aims at
TRACE_SHARE = 20  # ... covering at least 1 / TRACE_SHARE of the timed solve
GMRES_CYCLES = 3
GMRES_RESTART = 10
PIECE_GMRES_RTOL = 2e-4   # tests/test_torch_sharded_solvers.py's bounds
PIECE_PCG_ENTRIES = 31  # entries reported beside the CPU test's 30 iterations
PIECE_BICG_RTOL = 1e-5
# block systems on pieces: name -> (-dim, grid, solver, environment switch)
PIECE_BLOCK_RUNS = {
    "block s-step CG 2-D": (2, (N_GRID, N_GRID), "CGSolver", None),
    "block two-pass CG 2-D": (2, (N_GRID, N_GRID), "CGSolver",
                              "LEGIONSOLVERS_NO_SSTEP"),
    "block BiCGStab 2-D": (2, (N_GRID, N_GRID), "BiCGStabSolver", None),
    "block CG 3-D": (3, SHAPE3, "CGSolver", None),
}
PIECE_CLI_RUNS = {
    "-dim 3 -solver 1": ["-dim", "3", "-nx", "256", "-ny", "256", "-nz",
                         "256", "-solver", "1", "-it", str(PIECE_CLI_ITERS)],
    "-dim 2 -solver 2": ["-dim", "2", "-solver", "2", "-it",
                         str(PIECE_CLI_ITERS)],
    "-dim 2 -solver 3": ["-dim", "2", "-solver", "3", "-restart", "10",
                         "-it", "20"],
    "-dim 2 -solver 4": ["-dim", "2", "-solver", "4", "-it",
                         str(PIECE_CLI_ITERS)],
    "-dim 2 --block": ["-dim", "2", "-solver", "1", "--block", "-it",
                       str(PIECE_CLI_ITERS)],
}


def piece_cli_expected(label, runs):
    """Exact launches of one CLI run on PIECES pieces, from its solves
    (``benchmark.RUNS``): one piece's (:func:`cli_expected`) times the
    pieces (and the spaces of ``--block``), K1's compute ceiling once."""
    solves = {k: c for k, c in runs.items() if isinstance(k, int)}
    total = lambda f: sum(c * f(k) for k, c in solves.items())
    if label == "-dim 3 -solver 1":
        return {"pq3d": PIECES * total(lambda k: 1),
                "update3d": PIECES * total(lambda k: k),
                "xpay_pq3d": PIECES * total(lambda k: k - 1)}
    if label == "-dim 2 -solver 2":
        return {m: PIECES * total(lambda k: k) for m in BICG_KERNELS}
    if label == "-dim 2 -solver 3":
        return {"y": PIECES * total(lambda k: 11 * k + 1)}
    if label == "-dim 2 -solver 4":
        return {"y_dot": PIECES * total(lambda k: k)}
    return {"step2": 2 * PIECES * total(lambda k: k // 2)
            + runs["step2_ceiling"],
            "gram2": 2 * PIECES * total(lambda k: max(1, -(-(k // 2) // 16)))}


def counted_solve(torch, T, solver, iters):
    """(history, x, launches) of one solve(iters) from x0 = 0."""
    restart(solver)
    torch.cuda.synchronize()
    T.reset_launch_counts()
    hist = solver.solve(iters)
    torch.cuda.synchronize()
    counts = dict(T.LAUNCHES)
    T.reset_launch_counts()
    return hist, solver.planner.sol_vectors[0].data.clone(), counts


def finite_upto(h):
    """The number of leading finite entries of a history."""
    import torch

    bad = (~torch.isfinite(h)).nonzero()
    return int(bad[0]) if len(bad) else len(h)


def pieces_solvers_path(torch, np, T, TB, T3, TB3, lt, device):
    """Phase 4j, the solves on pieces that the 2-D CG of
    :func:`pieces_path` does not cover, each through ``entry``'s builders
    on ``make_mesh(S, devices=[card] * S)`` and each also run under
    :class:`shadowed` (every launch held to its plain version on copies of
    its inputs):

    * the 3-D matvec, 7- and 27-point, at 4 and 8 pieces of 256^3 against
      one piece (4 eps max|x| sum|v|; whether y is bit for bit);
    * 3-D two-pass CG solve(PIECE_ITERS = 100) on 4 pieces, 7- and
      27-point: launches exactly (K6a pq 4, K6b 396, K6a update 400), one
      piece's 1, 99, 100, the history and x within
      phase 4c's envelope against float64 CG, a repeat bit for bit;
    * the fused 2-D BiCGStab solve(200) on 4 pieces at 4096^2 with f32
      and with compensated dots, and at 256^2 with compensated dots: K5a-c
      800 each, no plain version, the first two iterations within 1e-5 of
      one piece, ||b - Ax||^2 through the sharded matvec within 5e-2 of
      the history, a repeat bit for bit; with compensated dots, as phase
      4b, one iteration from the pieces' state at CONTINUE_AT kernel-driven
      against plain-driven (1e-2), held where the state is well
      conditioned: the plain-driven iteration from the state moved by one
      ulp moves by less than 1e-3.  A history that turns non-finite (P5)
      is reported: its continuation is not held and its residual is
      checked after GAP_ITERS;
    * 3-D BiCGStab step() on 4 pieces (BICG3_STEP_ITERS iterations,
      7-point, compensated dots, as phase 4d): one piece's step()s through
      two iterations (EAGER3_RTOL), ||b - Ax||^2 after GAP_ITERS within
      BICG3_GAP, launches 4 x one piece's;
    * GMRES(10) for 3 cycles and PCG(Jacobi) solve(200) on 4 pieces of the
      2-D 4096^2 system: one piece's history within 2e-4 (GMRES, the CPU
      test's bound) and within twice textbook f32 CG's distance from
      float64 CG (PCG: two f32 codes of one recurrence, as phase 4 holds
      f32 CG), launches 4 x one piece's;
    * block systems of 2 spaces on 4 pieces (PIECE_BLOCK_RUNS),
      solve(PIECE_ITERS): launches
      exactly twice one space's on the same pieces, the history exactly
      2x, every space's x bit for bit one space's;
    * the CLI's ``-vp 4`` for PIECE_CLI_RUNS: exits, reports 4 pieces, a
      share of its roofline in (0, 100] and its exact launches.

    Returns (launches by kernel (3-D ones keyed (name, dim)), the same in
    whole-grid launches, results, {run: (solver on pieces, one-piece
    solver (a block's: one space on the same pieces), environment switch
    of each, iterations, bytes or None)}, failed checks)."""
    from legionsolvers_tpu_torch import benchmark
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    f32c = lt.SolverOptions(entry_dtype=torch.float32, compensated_dots=True)
    modules = (T, TB, T3, TB3)
    mesh = lambda S: make_mesh(S, devices=[device] * S)
    launches, grid, results, solvers, checks = {}, {}, {}, {}, {}
    eps = torch.finfo(torch.float32).eps
    n2, n3 = N_GRID * N_GRID, math.prod(SHAPE3)

    def add(counts, S, dim=None):
        for m, c in counts.items():
            key = (m, dim) if dim and m.endswith("3d") else m
            launches[key] = launches.get(key, 0) + c
            grid[key] = grid.get(key, 0.0) + c / S

    t_run = time.perf_counter()

    def record(name, chk, res):
        for k, ok in chk.items():
            checks[f"{name}: {k}"] = ok
        res["checks"] = chk
        results[name] = res
        log(f"[pieces] {name}: " + "; ".join(
            f"{k} {v}" for k, v in res.items() if k != "checks")
            + "; checks " + "; ".join(f"{k} {ok}" for k, ok in chk.items()))
        log(f"[elapsed] phase 4j, {name}: "
            f"{time.perf_counter() - t_run:.1f} s")

    def shadow_run(solver, iters, **mods):
        with shadowed(T, solver, **mods) as sh:
            restart(solver)
            solver.solve(iters)
            torch.cuda.synchronize()
        T.reset_launch_counts()
        return sh

    def shadow_res(sh):
        return {"kernel vs plain per launch": sh.worst,
                "share of bound per launch": sh.share,
                "out of bounds": sh.bad}

    # -- the 3-D matvec on 4 and 8 pieces against one piece ---------------
    gen = torch.Generator(device).manual_seed(PIECE_SEED)
    x = torch.rand(SHAPE3, generator=gen, device=device)
    for dim in DIMS3:
        pts = 7 if dim == 3 else 27
        vals = [v for _, v in lt.laplacian_stencil(dim)]
        bound = 4 * eps * x.abs().max().item() * sum(abs(v) for v in vals)
        y1 = build_stencil_system(dim, SHAPE3, f32, device) \
            .row_partitioned_matrices[0][0].matvec(x)
        for S in (PIECES, 2 * PIECES):
            op = build_stencil_system(dim, SHAPE3, f32, mesh=mesh(
                S)).row_partitioned_matrices[0][0]
            torch.cuda.synchronize()
            T.reset_launch_counts()
            yS = op.matvec(x)
            torch.cuda.synchronize()
            got = dict(T.LAUNCHES)
            T.reset_launch_counts()
            err = (yS - y1).abs().max().item()
            bits = same_bits(yS, y1)
            with shadowed(T, T3=T3) as sh:
                op.matvec(x)
            torch.cuda.synchronize()
            T.reset_launch_counts()
            add(got, S, dim)
            record(f"3-D matvec {pts}-point on {S} pieces", {
                f"within {bound:.3g} of one piece": err <= bound,
                f"launches exactly {{'y3d': {S}}}": got == {"y3d": S},
                "each K6a y equals its plain version on the same inputs":
                    not sh.bad and sh.calls == {"y3d": S},
            }, {"max_abs_err": err, "bound": bound, "bit for bit": bits,
                "launches": got, **shadow_res(sh)})
            del op, yS
        del y1
    del x

    # -- 3-D two-pass CG on 4 pieces ----------------------------------------
    for dim in DIMS3:
        pts = 7 if dim == 3 else 27
        name = f"3-D CG {pts}-point, {PIECES} pieces"
        solver = lt.CGSolver(build_stencil_system(dim, SHAPE3, f32,
                                                  mesh=mesh(PIECES)))
        single = lt.CGSolver(build_stencil_system(dim, SHAPE3, f32, device))
        solvers[name] = (solver, single, None, None, PIECE_ITERS,
                         (24 + 32 * (PIECE_ITERS - 1)) * n3)
        h1, (x1,), c1, p1, _ = block_run(torch, T, single, modules,
                                         PIECE_ITERS)
        h, (xs,), c, p, _ = block_run(torch, T, solver, modules, PIECE_ITERS)
        h2, (xs2,), c2, _, _ = block_run(torch, T, solver, modules,
                                         PIECE_ITERS)
        sh = shadow_run(solver, PIECE_ITERS, T3=T3)
        A = stencil_matvec(torch, lt, dim)
        h64, x64 = classic_cg(torch, SHAPE3, PIECE_ITERS, torch.float64,
                              device, A)
        h32, x32 = classic_cg(torch, SHAPE3, PIECE_ITERS, torch.float32,
                              device, A)
        env = {"textbook f32": (max_rel(h32, h64), x_rel(x32, x64)),
               "pieces": (max_rel(h, h64), x_rel(xs, x64)),
               "one piece": (max_rel(h1, h64), x_rel(x1, x64))}
        k_env, t_env = env["pieces"], env["textbook f32"]
        add(c, PIECES, dim)
        record(name, {
            f"launches exactly {PIECE3_LAUNCHES}": c == c2 == PIECE3_LAUNCHES
            and c1 == PIECE3_ONE,
            "no plain version called": p + p1 == 0,
            "history and x within twice textbook f32 CG's distance from "
            f"float64 CG (floor {CG3_F64_FLOOR})":
                bool(torch.isfinite(h).all())
                and k_env[0] <= max(2 * t_env[0], CG3_F64_FLOOR)
                and k_env[1] <= max(2 * t_env[1], CG3_F64_FLOOR),
            "a repeat bit for bit": same_bits(h2, h) and same_bits(xs2, xs),
            "every launch equals its plain version on the same inputs":
                not sh.bad and sh.calls == PIECE3_LAUNCHES,
        }, {"launches": c, "launches one piece": c1, "vs float64": env,
            "vs one piece": (max_rel(h, h1), x_rel(xs, x1)),
            **shadow_res(sh)})
        del xs, xs2, x1, x32, x64

    # -- the fused 2-D BiCGStab on 4 pieces ---------------------------------
    for n, opts, label in ((N_GRID, f32, "f32 dots"),
                           (N_GRID, f32c, "compensated dots"),
                           (SMALL_GRID, f32c, "compensated dots")):
        name = f"2-D BiCGStab {n}^2 {label}, {PIECES} pieces"
        planner = build_stencil_system(2, (n, n), opts, mesh=mesh(PIECES))
        op = planner.row_partitioned_matrices[0][0]
        if not op.supports_fused_bicgstab:
            raise AssertionError(f"{name}: no fused BiCGStab on pieces")
        solver = lt.BiCGStabSolver(planner)
        single = lt.BiCGStabSolver(build_stencil_system(2, (n, n), opts,
                                                        device))
        solvers[name] = (solver, single, None, None, N_ITERS,
                         (60 * N_ITERS + 16) * n * n)
        h1, (x1,), c1, p1, _ = block_run(torch, T, single, modules)
        h, (xs,), c, p, _ = block_run(torch, T, solver, modules)
        h2, (xs2,), c2, _, _ = block_run(torch, T, solver, modules)
        sh = shadow_run(solver, N_ITERS, TB=TB)
        fin = finite_upto(h)
        cont = []
        for k in (CONTINUE_AT if opts.compensated_dots else ()):
            restart(solver)
            if k:
                solver.solve(k)
            snap = snapshot(solver)
            if not all(bool(torch.isfinite(v).all())
                       for v in snap[0].values()):
                cont.append((k, None, None, None, None))
                continue
            outs = []
            for plain in (False, True):
                restore(solver, snap)
                if plain:
                    with plain_driven(TB, solver, bicg_plain(TB)):
                        hk = solver.solve(1)
                else:
                    hk = solver.solve(1)
                outs.append((hk[1], planner.sol_vectors[0].data.clone(),
                             planner.get_vector(solver.R, 0).data.clone()))
            # the state's condition: the plain-driven iteration again from
            # the state with every vector moved by one f32 ulp (signs from
            # a seeded generator)
            restore(solver, snap)
            g = torch.Generator(device).manual_seed(k)
            for i in (solver.SOL, solver.R, solver.P, solver.V):
                d = planner.get_vector(i, 0).data
                d.mul_(1 + eps * torch.randint(0, 2, d.shape, generator=g,
                                               device=device) * 2 - eps)
            with plain_driven(TB, solver, bicg_plain(TB)):
                hq = solver.solve(1)
            outs.append((hq[1], planner.sol_vectors[0].data.clone(),
                         planner.get_vector(solver.R, 0).data.clone()))
            (hk, xk, rk), (hp, xp, rp), (hq, xq, rq) = outs
            vec = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
            cont.append((k, max_rel(hk, hp), vec(xk, xp), vec(rk, rp),
                         max(max_rel(hq, hp), vec(xq, xp), vec(rq, rp))))
        T.reset_launch_counts()
        gap_iters = N_ITERS if fin == len(h) else GAP_ITERS
        restart(solver)
        hg = solver.solve(gap_iters)
        planner.matvec(solver.U, solver.SOL)
        torch.cuda.synchronize()
        T.reset_launch_counts()
        b = planner.rhs_vectors[0].data
        true_rr = torch.sum((b - planner.get_vector(solver.U, 0).data)
                            .double() ** 2).item()
        gap = abs(true_rr - hg[-1].item()) / hg[-1].item()
        first = max_rel(h[:3], h1[:3])
        chk = {
            f"launches exactly {PIECE_BICG_LAUNCHES}":
                c == c2 == PIECE_BICG_LAUNCHES
                and c1 == {m: N_ITERS for m in BICG_KERNELS},
            "no plain version called": p + p1 == 0,
            f"the first two iterations within {PIECE_BICG_RTOL} of one "
            "piece": first <= PIECE_BICG_RTOL,
        }
        if cont and fin == len(h):
            # as phase 4b, with compensated dots, at the states where one
            # iteration is well conditioned (a one-ulp move of the state
            # moves it by less than 1e-3); the ill-conditioned states of
            # this chaotic recurrence (P5) and a draw that turns non-finite
            # are reported, not held
            held = [c_ for c_ in cont if c_[4] < 1e-3]
            chk["one iteration from the pieces' well-conditioned states "
                f"({[c_[0] for c_ in held]}), kernel vs plain, 1e-2"] = (
                bool(held) and max(max(c_[1:4]) for c_ in held) <= 1e-2)
        add(c, PIECES)
        record(name, {
            **chk,
            f"||b - Ax||^2 vs history after {gap_iters}, rel 5e-2":
                gap <= 5e-2,
            "a repeat bit for bit": same_bits(h2, h) and same_bits(xs2, xs),
            "every launch equals its plain version on the same inputs":
                not sh.bad and sh.calls == PIECE_BICG_LAUNCHES,
        }, {"launches": c, "first entries vs one piece": first,
            "finite entries (pieces, one piece)": (fin, finite_upto(h1)),
            "continuation (k, history, x, r; a one-ulp move)": cont,
            "||b-Ax||^2": true_rr, "history": hg[-1].item(), "gap": gap,
            "vs one piece (history, x)": (max_rel(h, h1), x_rel(xs, x1)),
            **shadow_res(sh)})
        del xs, xs2, x1

    # -- BiCGStab step() on 3-D pieces --------------------------------------
    name = f"3-D BiCGStab step() 7-point compensated, {PIECES} pieces"
    planner = build_stencil_system(3, SHAPE3, f32c, mesh=mesh(PIECES))
    solver = lt.BiCGStabSolver(planner)
    if solver._make_fused_runner(BICG3_STEP_ITERS) is not None:
        raise AssertionError("3-D pieces took a fused BiCGStab runner")
    single = lt.BiCGStabSolver(build_stencil_system(3, SHAPE3, f32c, device))
    solvers[name] = (solver, single, None, "LEGIONSOLVERS_NO_FUSED_BICGSTAB",
                     BICG3_STEP_ITERS, None)
    restart(single)
    eager = [single.residual_norm_squared().value]
    for _ in range(2):
        single.step()
        eager.append(single.residual_norm_squared().value)
    eager = torch.stack(eager)
    with env_route("LEGIONSOLVERS_NO_FUSED_BICGSTAB", single):
        _, _, c1 = counted_solve(torch, T, single, BICG3_STEP_ITERS)
    h, _, c = counted_solve(torch, T, solver, BICG3_STEP_ITERS)
    sh = shadow_run(solver, BICG3_STEP_ITERS, T3=T3)
    restart(solver)
    hg = solver.solve(GAP_ITERS)
    planner.matvec(solver.U, solver.SOL)
    torch.cuda.synchronize()
    T.reset_launch_counts()
    true_rr = torch.sum((planner.rhs_vectors[0].data - planner.get_vector(
        solver.U, 0).data).double() ** 2).item()
    gap = abs(true_rr - hg[-1].item()) / hg[-1].item()
    dev = rel_dev(h[:3], eager)
    one = {"y3d": BICG3_STEP_ITERS, "y_dot3d": BICG3_STEP_ITERS}
    want = {m: PIECES * k for m, k in one.items()}
    add(c, PIECES, 3)
    record(name, {
        f"launches exactly {want}": c == want and c1 == one,
        f"one piece's step()s through two iterations, rtol {EAGER3_RTOL}":
            eager_ok(dev),
        f"||b - Ax||^2 vs history after {GAP_ITERS}, rel {BICG3_GAP}":
            gap <= BICG3_GAP,
        "history finite": bool(torch.isfinite(h).all()),
        "every launch equals its plain version on the same inputs":
            not sh.bad and sh.calls == want,
    }, {"launches": c, "vs one piece's step()s": dev.tolist(),
        "||b-Ax||^2": true_rr, "gap": gap, **shadow_res(sh)})

    # -- GMRES and PCG on 2-D pieces ----------------------------------------
    for kind in ("GMRES(10)", "PCG(Jacobi)"):
        name = f"2-D {kind}, {PIECES} pieces"
        made = []
        for m in (mesh(PIECES), None):
            planner = build_stencil_system(2, (N_GRID, N_GRID), f32, device
                                           if m is None else None, mesh=m)
            made.append(lt.GMRESSolver(planner, GMRES_RESTART)
                        if kind.startswith("GMRES") else
                        pcg_solver(lt, planner))
        solver, single = made
        iters = GMRES_CYCLES if kind.startswith("GMRES") else N_ITERS
        solvers[name] = (solver, single, None, None, iters, None)
        (h1, x1, c1), (h, xs, c), (h2, xs2, _) = (
            counted_solve(torch, T, slv, iters)
            for slv in (single, solver, solver))
        sh = shadow_run(solver, iters)
        if kind.startswith("GMRES"):
            one = {"y": 11 * iters + 1}
            held = max_rel(h, h1) <= PIECE_GMRES_RTOL
            rule = f"history within {PIECE_GMRES_RTOL} of one piece"
        else:
            # two f32 codes of one recurrence, sums in other orders: held
            # to each other within twice textbook f32 CG's distance from
            # float64 CG (phase 4's envelope)
            one = {"y_dot": iters}
            h64, _ = classic_cg(torch, (N_GRID, N_GRID), N_ITERS,
                                torch.float64, device)
            h32, _ = classic_cg(torch, (N_GRID, N_GRID), N_ITERS,
                                torch.float32, device)
            envelope = 2 * max_rel(h32, h64)
            held = max_rel(h, h1) <= envelope
            rule = (f"history within twice textbook f32 CG's distance from "
                    f"float64 ({envelope:.3g}) of one piece's")
        want = {m: PIECES * k for m, k in one.items()}
        add(c, PIECES)
        record(name, {
            f"launches exactly {want}": c == want and c1 == one,
            rule: held,
            "history finite": bool(torch.isfinite(h).all()),
            "a repeat bit for bit": same_bits(h2, h) and same_bits(xs2, xs),
            "every launch equals its plain version on the same inputs":
                not sh.bad and sh.calls == want,
        }, {"launches": c, "vs one piece (history, x)": (max_rel(h, h1),
                                                         x_rel(xs, x1)),
            f"first {PIECE_PCG_ENTRIES} entries vs one piece":
                max_rel(h[:PIECE_PCG_ENTRIES], h1[:PIECE_PCG_ENTRIES]),
            **shadow_res(sh)})
        del xs, xs2, x1

    # -- block systems on 4 pieces ------------------------------------------
    for name, (dim, shape, cls_name, env) in PIECE_BLOCK_RUNS.items():
        cls = getattr(lt, cls_name)
        block = cls(build_stencil_system(dim, shape, f32, num_spaces=2,
                                         mesh=mesh(PIECES)))
        single = cls(build_stencil_system(dim, shape, f32, mesh=mesh(PIECES)))
        with env_route(env, block, single):
            h1, (x1,), c1, p1, k1 = block_run(torch, T, single, modules,
                                              PIECE_ITERS)
            h, xs, c, p, k = block_run(torch, T, block, modules,
                                       PIECE_ITERS)
            h2, xs2, c2, _, _ = block_run(torch, T, block, modules,
                                          PIECE_ITERS)
            sh = shadow_run(block, PIECE_ITERS, TB=TB, T3=T3)
        twice = {m: 2 * n for m, n in c1.items()}
        add(c, PIECES, dim)
        solvers[f"{name}, {PIECES} pieces"] = (block, single, env, env,
                                               PIECE_ITERS, None)
        record(f"{name}, {PIECES} pieces", {
            "launches exactly twice one space's on the same pieces":
                bool(c1) and c == c2 == twice,
            "no plain version called": p + p1 == 0,
            "history exactly twice one space's": same_bits(h, 2 * h1),
            "every space's x bit for bit one space's":
                all(same_bits(xx, x1) for xx in xs),
            "a repeat bit for bit": same_bits(h2, h)
            and all(same_bits(a, b) for a, b in zip(xs2, xs)),
            "every launch equals its plain version on the same inputs":
                not sh.bad and sh.calls == twice,
        }, {"launches": c, "launches one space": c1,
            "cg2_coeffs (block, one space)": (k, k1), **shadow_res(sh)})
        del xs, xs2, x1

    # -- the CLI's -vp 4 ------------------------------------------------------
    bw = copy_bandwidth(torch, device)
    for label, argv in PIECE_CLI_RUNS.items():
        T.reset_launch_counts()
        out = benchmark.main(argv + ["-vp", str(PIECES)], bw=bw)
        torch.cuda.synchronize()
        got = {m: n for m, n in T.LAUNCHES.items()
               if not m.startswith("chain_")}
        T.reset_launch_counts()
        want = piece_cli_expected(label, benchmark.RUNS)
        pct = out["pct_roofline"]
        add(got, PIECES, 3 if label.startswith("-dim 3") else None)
        record(f"CLI -vp {PIECES} {label}", {
            "reports the pieces and a share of its roofline in (0, 100]":
                out["pieces"] == PIECES and pct is not None
                and 0 < pct <= 100 and math.isfinite(out["final_residual2"]),
            "launches exactly as its solves": got == want,
        }, {k: out[k] for k in ("ms_per_iter", "gnnz_per_s", "pct_roofline",
                                "schedule", "final_residual2")})
    failed = [k for k, ok in checks.items() if not ok]
    log(f"[pieces] solvers on pieces, checks: {len(checks) - len(failed)} "
        f"of {len(checks)} hold" + (f"; FAILED: {failed}" if failed else ""))
    return launches, grid, results, solvers, failed


def time_piece_solvers(torch, solvers, bw, card):
    """Phase 5j for :func:`pieces_solvers_path`'s solves: ms/iter (CUDA
    events, the better of two solves after a warm-up) and host enqueue
    ms/iter on pieces and on one piece (a block's: one space on the same
    pieces) in the same process, and torch glue operations per iteration
    counted on the host (:class:`glue_ops`); the idle share follows after
    every timing (:func:`profile_piece_solvers`).  GMRES's iterations are
    its cycles.  {run: {"pieces": {...}, "one piece": {...}}}."""
    out = {}
    for name, (solver, single, env, env1, iters, nbytes) in solvers.items():
        row = {}
        for label, slv, e in (("pieces", solver, env),
                              ("one piece", single, env1)):
            with env_route(e, slv):
                ms, host = solve_ms(torch, slv, iters)
                if nbytes is not None:
                    sane(f"{name} {label} solve", ms, nbytes, bw)
                restart(slv)
                torch.cuda.synchronize()
                with glue_ops() as glue:
                    slv.solve(iters)
                torch.cuda.synchronize()
            row[label] = {"ms/iter": ms / iters, "host ms/iter": host / iters,
                          "glue ops per iteration": glue.total / iters,
                          "glue ops by name": glue.ops}
        out[name] = row
        log(f"[time] {name} solve({iters}): " + "; ".join(
            f"{lab} {r['ms/iter']:.4f} ms/iter, host enqueue "
            f"{r['host ms/iter']:.4f}, {r['glue ops per iteration']:.2f} "
            f"torch glue ops per iteration" for lab, r in row.items())
            + f" on {card}")
    return out


def profile_piece_solvers(torch, solvers, times, card):
    """The idle share of each solve of :func:`time_piece_solvers`, 1 -
    profiler device time per iteration over the unprofiled wall's, after
    every timing.  A trace of the whole solve costs the tracer's host time
    per glue operation, so a solve of many glue operations per iteration
    is traced over fewer iterations (about TRACE_OPS operations, at least
    1 / TRACE_SHARE of the timed iterations); a short trace of a device-bound
    solve would read low (the first kernels of a trace go missing), and
    those keep their whole length."""
    for name, (solver, single, env, env1, iters, _) in solvers.items():
        for label, slv, e in (("pieces", solver, env),
                              ("one piece", single, env1)):
            row = times[name][label]
            n = min(iters, max(1, iters // TRACE_SHARE, round(
                TRACE_OPS / max(row["glue ops per iteration"], 1))))
            row["traced iterations"] = n
            with env_route(e, slv):
                dev = profile_solve(
                    torch, slv, "pieces_" + "".join(
                        ch if ch.isalnum() else "_" for ch in name)
                    + ("" if label == "pieces" else "_one"), card,
                    row["ms/iter"] * n, n)
            row["device ms/iter"] = dev / n
            row["idle"] = 1 - row["device ms/iter"] / row["ms/iter"]
        log(f"[time] {name}: idle " + "; ".join(
            f"{lab} {100 * r['idle']:.1f}% (device {r['device ms/iter']:.4f}"
            f" ms/iter over {r['traced iterations']} traced)"
            for lab, r in times[name].items()) + f" on {card}")
    return times


# phases 4k and 5k: explicit matrices on pieces of the card
# (entry.build_explicit_system(..., mesh=make_mesh(4, devices=[card] * 4)))
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]
# system and route of each build: (explicit_coo's name, prefer_dia)
XP_BUILDS = {"DIA 4096^2": ("dia", True),
             "sharded ELL 4096^2": ("dia", False),
             "scrambled 2048^2": ("scrambled", True),
             "random 2^20": ("random", True)}
# what the planner must pick on 4 pieces (JAX's choice on a 4-device mesh,
# found on the CPU): the operator chain, and the plan's geometry
XP_CHAIN = {"DIA 4096^2": ["DiaOperator"],
            "sharded ELL 4096^2": ["RowPartitionedMatrix"],
            "scrambled 2048^2": ["ReorderedOperator", "RowPartitionedMatrix"],
            "random 2^20": ["RowPartitionedMatrix"]}
XP_GEOMETRY = {"DIA 4096^2": {"C": N_GRID, "Br": N_GRID // PIECES, "D": 5},
               "sharded ELL 4096^2": {"win": True, "KR": 40, "L": 5, "Rt": 8},
               "scrambled 2048^2": {"win": True, "KR": 24, "L": 5, "Rt": 8},
               "random 2^20": {"win": False}}
# the solves: run -> (build, solver, the kernel each iteration launches once
# per piece, or None)
XP_RUNS = {"DIA 4096^2 CG": ("DIA 4096^2", "cg", "dia2d_dot"),
           "DIA 4096^2 PCG": ("DIA 4096^2", "pcg", "dia2d_dot"),
           "sharded ELL 4096^2 CG": ("sharded ELL 4096^2", "cg", "winell"),
           "scrambled 2048^2 CG": ("scrambled 2048^2", "cg", "winell"),
           "random 2^20 CG": ("random 2^20", "cg", None)}
XP_GAP_AT = 4  # the random system's ||b - Ax||^2 check (phase 4g's)


class shadowed_sparse:
    """Within the block, every K8 and K9 call (``dia2d_matvec``,
    ``winell_spmv``) also runs its plain version on the same inputs (a
    copy of the vector, taken before the kernel writes; the operator's
    coefficient tables, which no launch writes, as they are) and holds the
    kernel's outputs to it at phase 3's bounds: arrays elementwise to 1e-5
    of the plain version's max |value|, K8's dot to 1e-4 of
    sqrt(<x,x><y,y>).  ``calls``: {launch name: calls held}; ``worst``,
    ``share``, ``bad`` as :class:`shadowed`; ``exact``: every array bit for
    bit the plain version's."""

    def __init__(self):
        self.calls, self.worst, self.share, self.bad = {}, {}, {}, []
        self.exact = True

    def __enter__(self):
        from legionsolvers_tpu_torch.ops.cuda import dia2d as TD
        from legionsolvers_tpu_torch.ops.cuda import winell as TW

        self.saved = [(TD, "dia2d_matvec", TD.dia2d_matvec),
                      (TW, "winell_spmv", TW.winell_spmv)]
        TD.dia2d_matvec = self._wrap(TD.dia2d_matvec, TD.dia2d_plain)
        TW.winell_spmv = self._wrap(TW.winell_spmv, TW.winell_plain)
        return self

    def __exit__(self, *exc):
        for m, k, fn in self.saved:
            setattr(m, k, fn)

    def _wrap(self, kernel, plain):
        import torch

        def run(*args, **kw):
            cargs = [args[0].clone(), *args[1:]]
            ckw = {k: v for k, v in kw.items() if k != "out"}
            got = kernel(*args, **kw)
            ref = plain(*cargs, **ckw)
            if kernel is self.saved[0][2]:
                name = "dia2d_dot" if kw.get("with_dot") else "dia2d"
            else:
                name = "winell"
            self._check(name, got, ref, cargs[0])
            return got
        return run

    def _check(self, name, got, ref, x):
        import torch

        if name != "dia2d_dot":
            got, ref = (got,), (ref,)
        worst = share = 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            err = (g.double() - r.double()).abs().max()
            if i == 0:
                bound = 1e-5 * finite_max(r).double()
                self.exact &= bool(torch.equal(g, r))
            else:
                bound = 1e-4 * (torch.linalg.vector_norm(x.double())
                                * torch.linalg.vector_norm(ref[0].double()))
            err, bound = err.item(), bound.item()
            worst = max(worst, err)
            share = max(share, err / bound if bound else float(err > 0))
            if err > bound:
                self.bad.append((name, i, err))
        self.calls[name] = self.calls.get(name, 0) + 1
        self.worst[name] = max(self.worst.get(name, 0.0), worst)
        self.share[name] = max(self.share.get(name, 0.0), share)


def xp_geometry(op):
    """The geometry XP_GEOMETRY asserts of an operator on pieces."""
    base = getattr(op, "base", op)
    if type(base).__name__ == "DiaOperator":
        v = base._view
        return {"C": v["C"], "Br": v["Br"], "D": len(v["offs"])}
    w = base._win
    geo = {"win": w is not None, "offsets": base.halo.offsets,
           "halo_total": base.halo.halo_total, "L": base.row_length}
    if w is not None:
        geo.update(KR=w["KR"], L=int(w["cols"].shape[2]),
                   Rt=int(w["cols"].shape[3]))
    return geo


def build_explicit_pieces(torch, np, lt, name, device, mesh, source=None):
    """Phase 4k, one build: the system of XP_BUILDS through
    ``build_explicit_system(..., mesh=)``, its host seconds, and its
    operator chain and geometry checked against XP_CHAIN, XP_GEOMETRY.
    ``source``: a build of the same matrix (:func:`build_explicit`'s or
    this one's) whose COO arrays are taken as they are."""
    from legionsolvers_tpu_torch.entry import build_explicit_system

    system, prefer = XP_BUILDS[name]
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    t0 = time.perf_counter()
    if source is not None:
        rows, cols, vals, n = source["coo"]
        pr = source["pr"]
    else:
        rows, cols, vals, n, pr = explicit_coo(np, lt, system)
    A = lt.COOMatrix(rows, cols, vals, n, n, options=f32)
    t1 = time.perf_counter()
    planner = build_explicit_system(A, f32, prefer_dia=prefer, mesh=mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    op = planner.row_partitioned_matrices[0][0]
    geo = xp_geometry(op)
    ok = (chain(op) == XP_CHAIN[name] and getattr(op, "base", op).mesh is mesh
          and all(geo.get(k) == v for k, v in XP_GEOMETRY[name].items()))
    log(f"[explicit pieces] {name}: n {n}, nnz {A.n_kernel}; matrix "
        f"{t1 - t0:.1f} s, planner on {PIECES} pieces {t2 - t1:.1f} s on the "
        f"host; {chain(op)} {geo}")
    if not ok:
        raise AssertionError(f"{name} on {PIECES} pieces: the planner picked "
                             f"{chain(op)} {geo}")
    return {"planner": planner, "coo": (rows, cols, vals, n), "pr": pr,
            "host_s": (t1 - t0, t2 - t1), "geometry": geo,
            "nnz": A.n_kernel}


def xp_solver(lt, planner, kind):
    """A CG or PCG(Jacobi) solver on ``planner``; PCG takes the planner's
    workspace over (a CG solver on it keeps working: its vectors are the
    first three of PCG's four, and every restart derives them anew)."""
    if kind == "cg":
        return lt.CGSolver(planner)
    planner.workspace_vectors = []
    return lt.PCGSolver(planner, lt.JacobiPreconditioner(planner))


def explicit_pieces_path(torch, np, T, lt, device, one_piece):
    """Phase 4k.  (i) test_05's float64 golden on 4 pieces of the card:
    COO and CSR, n = 100, through the DIA upgrade and the sharded ELL
    (``prefer_dia=False``), exactly.  (ii)-(v) the builds of XP_BUILDS and
    the solves of XP_RUNS: solve(200) with its kernel launched exactly 4 x
    200 times (none for the random system, whose sharded ELL has no
    windowed plan) and no plain version called, a repeat bit for bit, the
    solve again with every K8 / K9 call held to its plain version
    (:class:`shadowed_sparse`), the history and x against float64 CG
    within twice textbook f32 CG's distance (over the finite entries for
    the random system, and ||b - Ax||^2 after XP_GAP_AT iterations within
    twice textbook f32's gap), and the distance from the one-piece solve of
    the same matrix (``one_piece``: {system: (its :func:`build_explicit`,
    its CG solver)}, whose COO arrays the builds here reuse) reported.
    Returns (launches, whole-grid launches, results, {run: (solver,
    one-piece solver or None, iterations, bytes or None)}, builds, failed
    checks)."""
    from legionsolvers_tpu_torch.entry import build_explicit_system
    from legionsolvers_tpu_torch.ops.cuda import dia2d as TD
    from legionsolvers_tpu_torch.ops.cuda import winell as TW
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(PIECES, devices=[device] * PIECES)
    checks, results, launches, grid, solvers = {}, {}, {}, {}, {}
    t_run = time.perf_counter()
    elapsed = lambda what: log(f"[elapsed] phase 4k, {what}: "
                               f"{time.perf_counter() - t_run:.1f} s")

    f64 = lt.SolverOptions(entry_dtype=torch.float64)
    for fmt, gen in (("COO", lt.coo_negative_laplacian_1d),
                     ("CSR", lt.csr_negative_laplacian_1d)):
        for route, prefer in (("DIA", True), ("sharded ELL", False)):
            pl = build_explicit_system(gen(100, options=f64), f64,
                                       prefer_dia=prefer, mesh=mesh)
            op = pl.row_partitioned_matrices[0][0]
            T.reset_launch_counts()
            hist = lt.CGSolver(pl).solve(10).tolist()
            want = ["DiaOperator"] if prefer else ["RowPartitionedMatrix"]
            checks[f"(i) {fmt} through {route} on {PIECES} pieces: the "
                   "golden exactly"] = (hist == GOLDEN and chain(op) == want
                                        and op.mesh is mesh)
            results[f"golden {fmt} {route}"] = hist
    T.reset_launch_counts()
    log(f"[explicit pieces] (i) golden on {PIECES} pieces: "
        + "; ".join(f"{k} {v == GOLDEN}" for k, v in results.items()))

    elapsed("the golden")
    builds = {}
    for name, (system, _) in XP_BUILDS.items():
        src = next((b for b in builds.values()
                    if XP_BUILDS[b["name"]][0] == system),
                   one_piece.get(system, (None,))[0])
        builds[name] = build_explicit_pieces(torch, np, lt, name, device,
                                             mesh, src)
        builds[name]["name"] = name
    elapsed("the builds")
    singles = {k: v[1] for k, v in one_piece.items()}
    refs = {system: v[0]["refs"] for system, v in one_piece.items()
            if "refs" in v[0]}
    for name, b in builds.items():
        system = XP_BUILDS[name][0]
        if system not in refs:
            refs[system] = explicit_refs(torch, np, b, system, device)
    plain = plain_names(TD, TW)
    for run, (bname, kind, counter) in XP_RUNS.items():
        b = builds[bname]
        system = XP_BUILDS[bname][0]
        solver = xp_solver(lt, b["planner"], kind)
        single = singles.get(system) if kind == "cg" else None
        ref, true_rr = refs[system]
        want = {counter: PIECES * N_ITERS} if counter else {}
        with counted_calls(plain, solver) as pc:
            restart(solver)
            torch.cuda.synchronize()
            T.reset_launch_counts()
            h = solver.solve(N_ITERS)
            torch.cuda.synchronize()
            c = dict(T.LAUNCHES)
            x = b["planner"].sol_vectors[0].data.clone()
            restart(solver)
            T.reset_launch_counts()
            h2 = solver.solve(N_ITERS)
            torch.cuda.synchronize()
            c2 = dict(T.LAUNCHES)
            repeat = same_bits(h, h2) and same_bits(
                x, b["planner"].sol_vectors[0].data)
        T.reset_launch_counts()
        with shadowed_sparse() as sh:
            restart(solver)
            solver.solve(N_ITERS)
            torch.cuda.synchronize()
        T.reset_launch_counts()
        h64, x64, h32, x32 = (ref[k] for k in ("h64", "x64", "h32", "x32"))
        win = finite_window(torch, h.double(), h64, h32)
        dev_k = max_rel(h[:win], h64[:win])
        dev_t = max_rel(h32[:win], h64[:win])
        finite_x = bool(torch.isfinite(x).all())
        xk = x_rel(x[: x64.numel()], x64) if finite_x else float("nan")
        xt = (x_rel(x32, x64) if bool(torch.isfinite(x32).all())
              else float("nan"))
        one = None
        if single is not None:
            restart(single)
            h1 = single.solve(N_ITERS)
            x1 = single.planner.sol_vectors[0].data
            w1 = finite_window(torch, h.double(), h1.double())
            one = (max_rel(h[:w1], h1[:w1]),
                   x_rel(x, x1) if finite_x else float("nan"))
        res = {"launches": c, "repeat launches": c2,
               "plain calls": sum(pc.calls.values()),
               "vs_f64": (dev_k, xk), "vs_f64 textbook f32": (dev_t, xt),
               "finite window": win, "vs one piece": one,
               "kernel vs plain per launch": sh.worst,
               "share of bound per launch": sh.share,
               "bit for bit the plain version": sh.exact,
               "out of bounds": sh.bad,
               "hist_first_last": (h[0].item(), h[-1].item())}
        chk = {
            f"launches exactly {want}": c == want == c2,
            "no plain version called": res["plain calls"] == 0,
            "a repeat bit for bit": repeat,
            "every K8 / K9 launch within phase 3's bounds of its plain "
            "version on the same inputs": not sh.bad and sh.calls == want,
            "b intact": bool((b["planner"].rhs_vectors[0].data[
                : b["coo"][3]] == 1.0).all()),
        }
        if counter is not None:
            chk["history and x within twice textbook f32's distance from "
                "float64"] = (win == N_ITERS + 1 and finite_x
                              and dev_k <= max(2 * dev_t, X_F64_FLOOR)
                              and xk <= max(2 * xt, X_F64_FLOOR))
        else:
            # f32 CG on the random system sinks into denormals (phase 4g):
            # the finite entries, and ||b - Ax||^2 after a few iterations
            restart(solver)
            hg = solver.solve(XP_GAP_AT)
            b["planner"].matvec(solver.Q, solver.SOL)
            bb = b["planner"].rhs_vectors[0].data
            rr = torch.sum((bb - b["planner"].get_vector(solver.Q, 0).data)
                           .double() ** 2).item()
            gap = abs(rr - hg[-1].item()) / hg[-1].item()
            T.reset_launch_counts()
            res["gap"] = gap
            chk["the finite entries within twice textbook f32's distance "
                "from float64, as long"] = (
                win >= finite_window(torch, h32, h64)
                and dev_k <= max(2 * dev_t, X_F64_FLOOR))
            chk[f"||b - Ax||^2 vs history after {XP_GAP_AT} within "
                f"{X_GAP_FLOOR}"] = gap <= X_GAP_FLOOR
            res["agree"] = (agree_window(h32, h64), agree_window(h, h64))
            chk["within 1e-3 of float64 as long as textbook f32"] = (
                res["agree"][1] >= res["agree"][0])
        for k, ok in chk.items():
            checks[f"{run}: {k}"] = ok
        res["checks"] = chk
        results[run] = res
        for m, k in c.items():
            launches[m] = launches.get(m, 0) + k
            grid[m] = grid.get(m, 0.0) + k / PIECES
        nbytes = None
        if counter is not None:
            nbytes = XP_BYTES[counter](b) * N_ITERS
        solvers[run] = (solver, single, N_ITERS, nbytes)
        log(f"[explicit pieces] {run}: launches {c}; against float64 CG "
            f"(history, x) {dev_k:.3g} {xk:.3g} over {win} entries "
            f"(textbook f32 {dev_t:.3g} {xt:.3g}); against one piece "
            f"{one}; each launch against its plain version: max abs err "
            f"{sh.worst}, share of bound {sh.share}, bit for bit "
            f"{sh.exact}; checks "
            + "; ".join(f"{k} {ok}" for k, ok in chk.items()))
        elapsed(run)
        del x
    del refs
    failed = [k for k, ok in checks.items() if not ok]
    log(f"[explicit pieces] checks: {len(checks) - len(failed)} of "
        f"{len(checks)} hold" + (f"; FAILED: {failed}" if failed else ""))
    return launches, grid, results, solvers, builds, failed


# minimum bytes of one iteration's matvec on pieces (the kernel's inputs and
# outputs; the halo copies and fix-ups are glue), plus CG's 48 B per unknown
XP_BYTES = {
    "dia2d_dot": lambda b: (2 + 5 + 12) * 4 * b["coo"][3],
    "winell": lambda b: (8 * b["geometry"]["L"] + 4 + 4 + 48) * b["coo"][3],
}


def time_explicit_pieces(torch, solvers, bw, card):
    """Phase 5k: for each run of XP_RUNS, ms/iter (CUDA events, the better
    of two solve(200)s after a warm-up) and host enqueue ms/iter on 4
    pieces and of the one-piece solve of the same matrix in the same
    process, the torch glue operations per iteration counted on the host
    (:class:`glue_ops`), and after every timing each one's idle share from
    a profiler trace (``TRACE_OPS`` glue operations, at least 1 /
    TRACE_SHARE of the iterations).  {run: {"pieces": {...}, "one piece":
    {...}}}."""
    out = {}
    for name, (solver, single, iters, nbytes) in solvers.items():
        row = {}
        for label, slv in (("pieces", solver), ("one piece", single)):
            if slv is None:
                continue
            ms, host = solve_ms(torch, slv, iters)
            if nbytes is not None and label == "pieces":
                sane(f"{name} {label} solve", ms, nbytes, bw)
            restart(slv)
            torch.cuda.synchronize()
            with glue_ops() as glue:
                slv.solve(iters)
            torch.cuda.synchronize()
            row[label] = {"ms/iter": ms / iters, "host ms/iter": host / iters,
                          "glue ops per iteration": glue.total / iters,
                          "glue ops by name": glue.ops}
        out[name] = row
        log(f"[time] {name} solve({iters}): " + "; ".join(
            f"{lab} {r['ms/iter']:.4f} ms/iter, host enqueue "
            f"{r['host ms/iter']:.4f}, {r['glue ops per iteration']:.2f} "
            f"torch glue ops per iteration" for lab, r in row.items())
            + f" on {card}")
    for name, (solver, single, iters, _) in solvers.items():
        for label, slv in (("pieces", solver), ("one piece", single)):
            if slv is None:
                continue
            row = out[name][label]
            n = min(iters, max(1, iters // TRACE_SHARE, round(
                TRACE_OPS / max(row["glue ops per iteration"], 1))))
            row["traced iterations"] = n
            dev = profile_solve(
                torch, slv, "xpieces_" + "".join(
                    ch if ch.isalnum() else "_" for ch in name)
                + ("" if label == "pieces" else "_one"), card,
                row["ms/iter"] * n, n)
            row["device ms/iter"] = dev / n
            row["idle"] = 1 - row["device ms/iter"] / row["ms/iter"]
        log(f"[time] {name}: idle " + "; ".join(
            f"{lab} {100 * r['idle']:.1f}% (device {r['device ms/iter']:.4f}"
            f" ms/iter over {r['traced iterations']} traced)"
            for lab, r in out[name].items()) + f" on {card}")
    return out


# --breakdown: right-hand sides b = 1 (phase 4d's or 4b's) and b = 1 + eps
# z, z standard normal from seeds 1 .. BREAKDOWN_RHS - 1; f32 histories
# over BREAKDOWN_ITERS iterations, to see breakdowns past N_ITERS
BREAKDOWN_RHS = 16
BREAKDOWN_EPS = 0.01
BREAKDOWN_ITERS = 300


# the f32 routes --breakdown --dim 2 also runs: the fused runner driven by
# the plain versions, by the plain versions but for one K5 kernel, and the
# eager step() transcription
BREAKDOWN_ROUTES2 = ("plain-driven fused", "K5a kernel alone",
                     "K5b kernel alone", "K5c kernel alone", "eager step()")


def breakdown(torch, lt, device, card, dim=3, n=N_GRID):
    """--breakdown [--dim 2|3|4] [--size n]: for the package this process
    imports, f32 BiCGStab from BREAKDOWN_RHS right-hand sides on phase
    4d's systems (dim 3: the 7-point stencil at SHAPE3; dim 4: the
    27-point one) or phase 4b's (dim 2: the 5-point Laplacian at n^2,
    N_GRID^2 by default; z drawn on the card as phase 4b's at N_GRID, with
    numpy's default_rng(seed) at other sizes, so that a CPU run can draw
    the same).  For each: the first non-finite history entry over
    BREAKDOWN_ITERS iterations of the port's solve (f32 dots) and of
    textbook f32, and with dim 2 of the BREAKDOWN_ROUTES2 too (the same
    fused schedule and its dots, each pass a kernel or its plain version,
    and the step() loop); the window (leading entries within 1e-3 of
    float64 BiCGStab) of the port's solve and of textbook f32, and of the
    compensated solve and textbook f32 with float64 dots; and the phase's
    end check after N_ITERS.  Dims 3 and 4, phase 4d's of the compensated
    solve: ||b - Ax||^2 within twice textbook f32's with float64 dots, x
    error within twice its or BICG3_X_FLOOR.  Dim 2, phase 4b's of the f32
    solve: ||b - Ax||^2 and x error within twice textbook f32's.  Per
    right-hand side one log line; last, one JSON line with, for each
    route, the right-hand sides that turned non-finite by N_ITERS and by
    BREAKDOWN_ITERS."""
    import numpy as np
    from legionsolvers_tpu_torch.entry import build_stencil_system, build_system
    from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB

    two = dim == 2
    shape = (n, n) if two else SHAPE3
    opts = lambda comp: lt.SolverOptions(entry_dtype=torch.float32,
                                         compensated_dots=comp)
    build = ((lambda comp: build_system(n, opts(comp), device)) if two
             else (lambda comp: build_stencil_system(dim, SHAPE3, opts(comp),
                                                     device)))
    solvers = {comp: lt.BiCGStabSolver(build(comp)) for comp in (False, True)}
    A = lap5 if two else stencil_matvec(torch, lt, dim)
    finite = lambda h: bool(torch.isfinite(h).all())
    first_bad = lambda h: (None if finite(h)
                           else int((~torch.isfinite(h)).nonzero()[0]))
    but = lambda name: {k: f for k, f in bicg_plain(TB).items()
                        if k != name}
    routes = {"plain-driven fused": lambda slv: plain_driven(
                  TB, slv, bicg_plain(TB)),
              "K5a kernel alone": lambda slv: plain_driven(
                  TB, slv, but("bicg_pv")),
              "K5b kernel alone": lambda slv: plain_driven(
                  TB, slv, but("bicg_st")),
              "K5c kernel alone": lambda slv: plain_driven(
                  TB, slv, but("bicg_update")),
              "eager step()": lambda slv: env_route(
                  "LEGIONSOLVERS_NO_FUSED_BICGSTAB", slv)}
    rows = []
    for k in range(BREAKDOWN_RHS):
        b = torch.ones(shape, device=device)
        if k and (not two or n == N_GRID):
            g = torch.Generator(device=device).manual_seed(k)
            b += BREAKDOWN_EPS * torch.randn(shape, generator=g,
                                             device=device)
        elif k:
            z = np.random.default_rng(k).standard_normal(shape)
            b += BREAKDOWN_EPS * torch.from_numpy(z.astype(np.float32)).to(
                device)
        runs = {}
        for comp, solver in solvers.items():
            planner = solver.planner
            planner.rhs_vectors[0].data.copy_(
                b.reshape(planner.rhs_vectors[0].data.shape))
            restart(solver)
            runs[comp] = (solver.solve(BREAKDOWN_ITERS if not comp
                                       else N_ITERS),
                          planner.sol_vectors[0].data.clone())
        hist, (hist_c, x_c) = runs[False][0], runs[True]
        b64 = b.double()
        h64, x64 = textbook_bicgstab(torch, shape, N_ITERS, torch.float64,
                                     device, matvec=A, rhs=b64)
        h32, _ = textbook_bicgstab(torch, shape, BREAKDOWN_ITERS,
                                   torch.float32, device, matvec=A, rhs=b)
        hd, xd = textbook_bicgstab(torch, shape, N_ITERS, torch.float32,
                                   device, dot_dtype=torch.float64,
                                   matvec=A, rhs=b)
        head = N_ITERS + 1
        row = {"rhs": "1" if not k else f"1 + {BREAKDOWN_EPS} z, seed {k}",
               "first_nonfinite": {"kernel": first_bad(hist),
                                   "textbook f32": first_bad(h32)},
               "window": {"kernel": agree_window(hist[:head], h64),
                          "textbook f32": agree_window(h32[:head], h64),
                          "kernel compensated": agree_window(hist_c, h64),
                          "textbook f32 (f64 dots)": agree_window(hd, h64)}}
        if two:
            solver = solvers[False]
            for route in BREAKDOWN_ROUTES2:
                with routes[route](solver):
                    restart(solver)
                    row["first_nonfinite"][route] = first_bad(
                        solver.solve(BREAKDOWN_ITERS))
            restart(solver)
            h200 = solver.solve(N_ITERS)
            x200 = solver.planner.sol_vectors[0].data.clone()
            h32s, x32s = textbook_bicgstab(torch, shape, N_ITERS,
                                           torch.float32, device, matvec=A,
                                           rhs=b)
            kq = solution_quality(torch, h200, x200, h64, x64, A, b64)
            tq = solution_quality(torch, h32s, x32s, h64, x64, A, b64)
            row["f32_end"] = {"x_err": kq[1], "x_err_textbook": tq[1],
                              "rr": kq[2], "rr_textbook": tq[2],
                              "pass": kq[2] <= 2 * tq[2]
                              and kq[1] <= 2 * tq[1]}
            del h32s, x32s, x200
        else:
            kq = solution_quality(torch, hist_c, x_c, h64, x64, A, b64)
            tq = solution_quality(torch, hd, xd, h64, x64, A, b64)
            row["compensated_end"] = {
                "x_err": kq[1], "x_err_textbook": tq[1],
                "rr": kq[2], "rr_textbook": tq[2],
                "pass": kq[2] <= 2 * tq[2]
                and kq[1] <= max(2 * tq[1], BICG3_X_FLOOR)}
        rows.append(row)
        end = row.get("f32_end", row.get("compensated_end"))
        log(f"[breakdown] b = {row['rhs']}: first non-finite "
            f"{row['first_nonfinite']}; window {row['window']}; "
            f"{'f32' if two else 'compensated'} end {end}")
        del h64, x64, h32, hd, xd, b64
        torch.cuda.empty_cache()
    nonfinite = {route: {str(by): sum(
        r["first_nonfinite"][route] is not None
        and r["first_nonfinite"][route] <= by for r in rows)
        for by in (N_ITERS, BREAKDOWN_ITERS)} for route in rows[0][
            "first_nonfinite"]}
    # the right-hand sides on which the compensated solve stays within 1e-3
    # of float64 as long as textbook f32 with float64 dots does, and meets
    # the end check (dims 3 and 4)
    comp = {} if two else {
        "window_as_long_as_textbook": sum(
            r["window"]["kernel compensated"]
            >= r["window"]["textbook f32 (f64 dots)"] for r in rows),
        "end_check": sum(r["compensated_end"]["pass"] for r in rows)}
    log(json.dumps({"card": card, "tree": os.getcwd(), "dim": dim,
                    "shape": list(shape), "iters": BREAKDOWN_ITERS,
                    "nonfinite_by": nonfinite, "compensated": comp,
                    "rows": rows}))
    return 0


# ---------------------------------------------------------------------------
# phase 4l: the 1-D kernel view (-dim 1): the flat route of the strip march
# (WRAP), the wide column shifts (band route), the 1-D solves at 2^24
# ---------------------------------------------------------------------------

N_FLAT = 1 << 24  # -dim 1's unknowns: the view [4096, 4096], 64 MiB a vector
FLAT_C = 4096
FLAT_GRID = (N_FLAT // FLAT_C, FLAT_C)
LAP1 = ((0, -1, 1), (2.0, -1.0, -1.0))  # the 1-D Laplacian's flat shifts
# C = 128, C = 1000 (scalar loads) with ragged rows, and rows of 4096
FLAT_EDGES = ((8, 128), (37, 1000), (3, 1000), (203, 4096))
FLAT_PIECES = 4
# name -> (solver, environment switch, pieces, solve length, launches):
# GMRES(10) solves 20 cycles (one residual and ten Arnoldi matvecs each,
# and the residual of the last x)
FLAT_RUNS = {
    "s-step CG": ("cg", None, 1, N_ITERS, {"step2": 100, "gram2": 7}),
    "two-pass CG": ("cg", "LEGIONSOLVERS_NO_SSTEP", 1, N_ITERS,
                    {"pq": 1, "update": N_ITERS, "xpay_pq": N_ITERS - 1}),
    "BiCGStab": ("bicg", None, 1, N_ITERS,
                 {m: N_ITERS for m in BICG_KERNELS}),
    "PCG": ("pcg", None, 1, N_ITERS, {"y_dot": N_ITERS}),
    "GMRES(10)": ("gmres", None, 1, N_ITERS // 10,
                  {"y": 11 * N_ITERS // 10 + 1}),
    "two-pass CG 4 pieces": ("cg", None, FLAT_PIECES, N_ITERS, {
        "pq": FLAT_PIECES, "update": FLAT_PIECES * N_ITERS,
        "xpay_pq": FLAT_PIECES * (N_ITERS - 1)}),
    "BiCGStab 4 pieces": ("bicg", None, FLAT_PIECES, N_ITERS,
                          {m: FLAT_PIECES * N_ITERS for m in BICG_KERNELS}),
}


def flat_kw(T, C):
    """The 1-D Laplacian on an [R, C] view, as ``decompose_flat_offsets``
    rewrites it (the row-wrap terms (-1, C - 1) and (1, -(C - 1)))."""
    offs, vals = T.decompose_flat_offsets(*LAP1, C)
    return dict(offsets=offs, values=vals)


def wide_kw(C):
    """The cross with column shifts past the tile's 8: (0, +-37), (1, -(C -
    1)) and one 8 rows up, (-8, 100): wide terms, which K3, K4 and K5a-c
    read on the band route."""
    return dict(offsets=OFFS + ((0, 37), (0, -37), (1, -(C - 1)), (-8, 100)),
                values=VALS + (-0.25, -0.25, -0.5, -0.125))


def lap3(v):
    """The 1-D 3-point negative Laplacian with zero boundary (torch)."""
    out = 2.0 * v
    out[1:] -= v[:-1]
    out[:-1] -= v[1:]
    return out


def flat_inputs(torch, T, shape, seed, device, halos, kw):
    """x, r, p on ``shape``, random [8, C] halo blocks (None without
    ``halos``), alpha, beta and K1's coefficients, for ``kw``."""
    d = one_pass_inputs(torch, shape, halos, device, seed)
    d["coef"] = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], **kw))[0]
    return d


def one_pass_bound(torch, T, mode, d, ref, kw):
    """1e-4 of the Cauchy-Schwarz scale of a one-pass mode's dot."""
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    A = lambda v, top, bot: T.apply_plain(v, kw["offsets"], kw["values"],
                                          top, bot)
    comb = lambda a, b: None if a is None else a + d["beta"] * b
    if mode == "y_dot":
        return 1e-4 * nrm(d["x"]) * nrm(ref["y"])
    if mode == "pq":
        return 1e-4 * nrm(d["p"]) * nrm(A(d["p"], d["pt"], d["pb"]))
    if mode == "update":
        return 1e-4 * nrm(ref["r"]) ** 2
    return 1e-4 * nrm(ref["p"]) * nrm(A(ref["p"], comb(d["rt"], d["pt"]),
                                        comb(d["rb"], d["pb"])))


def compare_flat_kernels(torch, T, TB, device):
    """Phase 4l, the kernels: every route of the 1-D view against its
    plain version on the decomposed offsets, at full width ([4096, 4096],
    random halo blocks) and at FLAT_EDGES (halo blocks null and random):
    K3's four modes, K4, K2, K1 and K5a-c (compensated dots off and on);
    and the wide terms (:func:`wide_kw`) of K3, K4 and K5a-c (the band
    route) at FLAT_EDGES.  Phase 3's bounds
    (elementwise 1e-5 * max|ref|, dots 1e-4 of their Cauchy-Schwarz
    scale), and a repeat on the same inputs bit for bit.  Returns ({pass:
    max abs error} of the flat route, the same of the wide terms)."""
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = {"flat": {}, "wide": {}}
    cases = [(FLAT_GRID, "flat", True)] + [
        (shape, st, halos) for shape in FLAT_EDGES
        for st in ("flat", "wide") for halos in (False, True)]
    for shape, st, halos in cases:
        kw = flat_kw(T, shape[1]) if st == "flat" else wide_kw(shape[1])
        route = T.route(kw["offsets"], kw["values"], shape[1])[0]
        k5_route = T.route(kw["offsets"], kw["values"], shape[1],
                           bicg="st")[0]
        k5a_route, k5c_route = (T.route(kw["offsets"], kw["values"],
                                        shape[1], bicg=k)[0]
                                for k in ("pv", "update"))
        if (route, k5a_route, k5_route, k5c_route) != (
                ("flat", "band", "flat", "band") if st == "flat"
                else ("band", "band", "band", "band")):
            raise AssertionError(f"{st} {shape} takes the {route} route "
                                 f"(K5a-c: {k5a_route}, {k5_route}, "
                                 f"{k5c_route})")
        d = flat_inputs(torch, T, shape, 53, device, halos, kw)
        worst, case = 0.0, f"{shape} {st} halos={halos}"
        modes = list(ONE_PASS_NAMES) + (["gram2", "step2"] if st == "flat"
                                        else [])
        for mode in modes:
            k1, k2, ref = (run_mode(T, mode, d, plain, kw)
                           for plain in (False, False, True))
            torch.cuda.synchronize()
            if not all(torch.equal(k1[k], k2[k]) for k in k1):
                raise AssertionError(f"{mode} {case}: a repeat is not "
                                     "bit-identical")
            for key, want in ref.items():
                err = (k1[key].double() - want.double()).abs()
                if key == "gram":
                    r, p = ((ref["r"], ref["p"]) if mode == "step2"
                            else (d["r"], d["p"]))
                    ok = bool((err.cpu() <= 1e-4 * gram_scales(
                        torch, T, r, p, kw)).all())
                elif key == "dot":
                    ok = err.item() <= one_pass_bound(torch, T, mode, d,
                                                      ref, kw)
                else:
                    ok = err.max().item() <= 1e-5 * want.abs().max().item()
                if not ok:
                    raise AssertionError(
                        f"{mode} {case} {key}: kernel disagrees with its "
                        f"plain version ({err.max().item():g})")
                e = errs[st]
                e[mode] = max(e.get(mode, 0.0), err.max().item())
                worst = max(worst, err.max().item())
        b = bicg_inputs(torch, shape, 59, device)
        for comp in (False, True):
            for name in BICG_KERNELS:
                k1, k2, ref = (run_bicg(TB, name, b, comp, plain, kw)
                               for plain in (False, False, True))
                torch.cuda.synchronize()
                if not all(torch.equal(k1[k], k2[k]) for k in k1):
                    raise AssertionError(f"{name} {case} compensated={comp}: "
                                         "a repeat is not bit-identical")
                ops = bicg_operands(T, name, b, ref, kw)
                for key, want in ref.items():
                    err = (k1[key].double() - want.double()).abs().max()
                    if want.dim():
                        ok = err.item() <= 1e-5 * want.abs().max().item()
                    else:
                        a, c = ops[key]
                        ok = err.item() <= 1e-4 * nrm(a) * nrm(c)
                    if not ok:
                        raise AssertionError(
                            f"{name} {case} compensated={comp} {key}: kernel "
                            f"disagrees with its plain version ({err:g})")
                    e = errs[st]
                    e[name] = max(e.get(name, 0.0), err.item())
                    worst = max(worst, err.item())
        log(f"[flat1d] {case} ({route} route; K5 {k5_route}): K3, K4"
            + (", K2, K1" if st == "flat" else "") + ", K5 (compensated "
            f"off, on) == plain (max abs err {worst:.3g}); repeats bit for "
            "bit")
        del d, b
    return errs["flat"], errs["wide"]


# f32 BiCGStab on the 1-D Laplacian amplifies a rounding difference 3-5
# fold per iteration from the fifth on (textbook f32 against float64 on the
# CPU, dots in f32 and in float64: the two f32 codes stay within 3x of each
# other's distance from float64 per entry, and leave 1e-3 of float64 after
# 13-14 iterations at n = 2^20 and 2^22; one went non-finite at iteration
# 117).  So the kernel path is held within FLAT_BICG_RTOL of float64 over
# the entries where textbook f32 stays within a tenth of that.
FLAT_BICG_RTOL = 1e-3
# The s-step schedule's distance from float64 on the 1-D Laplacian turns on
# how each dot is rounded, in the kernels and in the plain versions alike:
# at 2^24 its Gram entries reach n^2 / 2, where the interior's share (about
# n) is 2 / n of the sum, f32's epsilon (ROADMAP queue 3, P8).  Its history
# and x are held at phase 4c's rule, twice textbook f32 CG's distance with
# the floor X_F64_FLOOR, at 2^24 and at FLAT_ACC_SIZES; at each size the
# same schedule driven by the plain versions is logged beside the
# kernels', with f32 dots (JAX's) and with dots summed in float64 and
# rounded once (as K1/K2 sum them).
FLAT_ACC_SIZES = (1 << 20, 1 << 22)


def dot_f64(a, b):
    """A plain dot as K1/K2 sum theirs: f32 products in float64, rounded
    once."""
    return (a.double() * b.double()).sum().float()


def sstep_twins(torch, T, solver, iters, dist):
    """The s-step schedule of ``solver`` driven by the plain versions,
    with f32 dots and with :func:`dot_f64`: {label: dist(history, x)}."""
    x = solver.planner.sol_vectors[0]
    out = {}
    for label, dot in (("plain f32 dots", T._dot),
                       ("plain float64 dots", dot_f64)):
        saved, T._dot = T._dot, dot
        try:
            with plain_driven(T, solver, cg_plain(T)):
                restart(solver)
                out[label] = dist(solver.solve(iters), x.data)
        finally:
            T._dot = saved
    return out


def sstep_accuracy_1d(torch, T, lt, device, n):
    """Distance from float64 CG of f32 solve(200)s of the 1-D Laplacian at
    n: textbook f32 CG, and the s-step schedule driven by the kernels and
    by the plain versions (:func:`sstep_twins`).  {label: (max relative
    deviation of the history, max |x - x64| / max |x64|)}."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    planner = build_stencil_system(
        1, (n,), lt.SolverOptions(entry_dtype=torch.float32), device)
    if not planner.row_partitioned_matrices[0][0].step2_eligible:
        raise AssertionError(f"the 1-D operator at {n} is off the s-step "
                             "schedule")
    solver = lt.CGSolver(planner)
    h64, x64 = classic_cg(torch, (n,), N_ITERS, torch.float64, device,
                          matvec=lap3)
    h32, x32 = classic_cg(torch, (n,), N_ITERS, torch.float32, device,
                          matvec=lap3)
    dist = lambda h, x: (rel_dev(h, h64).max().item(),
                         x_rel(x.reshape(-1), x64))
    env = {"textbook f32": dist(h32, x32),
           "kernel": dist(solver.solve(N_ITERS), planner.sol_vectors[0].data)}
    env.update(sstep_twins(torch, T, solver, N_ITERS, dist))
    return env


def flat_solver(lt, planner, kind):
    if kind == "cg":
        return lt.CGSolver(planner)
    if kind == "bicg":
        return lt.BiCGStabSolver(planner)
    if kind == "pcg":
        return lt.PCGSolver(planner, lt.JacobiPreconditioner(planner))
    return lt.GMRESSolver(planner, 10)


def flat1d_path(torch, np, T, TB, lt, device):
    """Phase 4l, the solves: ``entry.build_stencil_system(1, (2^24,))`` on
    one piece and on 4 pieces of the card, each FLAT_RUNS solve from x0 =
    0 with its launches counted exactly (counts set to 0 just before it,
    read just after) and no plain version called; the operator on the 1-D
    view (C 4096; Br 4096, or 1024 on 4 pieces), the s-step schedule on one
    piece only, the fused BiCGStab on both.  The CG histories (s-step,
    two-pass, two-pass on 4 pieces, and PCG, which is CG here: the diagonal
    is constant) within twice textbook f32 CG's distance from float64 CG
    on the same 1-D system, and x too (the s-step's with the floor
    X_F64_FLOOR, and at FLAT_ACC_SIZES too: FLAT_ACC_SIZES' note);
    BiCGStab within FLAT_BICG_RTOL of float64 BiCGStab over the window
    where textbook f32 stays within a tenth of that; GMRES(10)
    non-increasing within GMRES_SLACK; every solve repeated from the same
    state, bit for bit.  Returns (launches by pass, whole-grid launches by
    pass, results, {run: solver}, failed)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    h64, x64 = classic_cg(torch, (N_FLAT,), N_ITERS, torch.float64, device,
                          matvec=lap3)
    h32, x32 = classic_cg(torch, (N_FLAT,), N_ITERS, torch.float32, device,
                          matvec=lap3)
    b64, bx64 = textbook_bicgstab(torch, (N_FLAT,), N_ITERS, torch.float64,
                                  device, matvec=lap3)
    b32, bx32 = textbook_bicgstab(torch, (N_FLAT,), N_ITERS, torch.float32,
                                  device, matvec=lap3)
    dist = lambda h, x, hr, xr: (rel_dev(h, hr).max().item(),
                                 x_rel(x.reshape(-1), xr))
    text_cg = dist(h32, x32, h64, x64)
    win32 = agree_window(b32, b64, FLAT_BICG_RTOL / 10)
    text_bi = (rel_dev(b32[:win32], b64[:win32]).max().item(),
               finite_window(torch, b32, b64))
    del x32, bx32
    launches, grid_launches, results, solvers, failed = {}, {}, {}, {}, []
    for name, (kind, env, pieces, iters, want) in FLAT_RUNS.items():
        mesh = (make_mesh(pieces, devices=[device] * pieces) if pieces > 1
                else None)
        planner = build_stencil_system(1, (N_FLAT,), f32, device, mesh=mesh)
        op = planner.row_partitioned_matrices[0][0]
        v = op._view
        solver = flat_solver(lt, planner, kind)
        with env_route(env, solver), counted_calls(
                plain_names(T, TB), solver) as plain:
            view_ok = (op.uses_pallas and v["flat"] and v["C"] == FLAT_C
                       and v["Br"] * pieces * FLAT_C == N_FLAT
                       and op.step2_eligible == (pieces == 1 and env is None)
                       and op.supports_fused_bicgstab)
            hist, x, counts = counted_solve(torch, T, solver, iters)
            hist2, x2, _ = counted_solve(torch, T, solver, iters)
        solvers[name] = solver
        checks = {"on the 1-D view (no linearized runner)": view_ok,
                  f"launches {want}": counts == want,
                  "no plain version called": not plain.calls,
                  "a repeat from the same state is bit-identical":
                      same_bits(hist, hist2) and same_bits(x, x2)}
        del x2
        if kind != "bicg":
            checks["finite history"] = bool(torch.isfinite(hist).all())
        res = {"launches": counts, "plain_calls": dict(plain.calls),
               "hist_first_last": (hist[0].item(), hist[-1].item())}
        if kind in ("cg", "pcg"):
            got = dist(hist, x, h64, x64)
            res["vs_f64"] = {"kernel": got, "textbook f32": text_cg}
            if name == "s-step CG":  # at f32's edge: see FLAT_ACC_SIZES
                res["vs_f64"].update(sstep_twins(
                    torch, T, solver, iters,
                    lambda h, x: dist(h, x, h64, x64)))
                floor = X_F64_FLOOR
                res["vs_f64"]["bound"] = tuple(
                    max(2 * t, floor) for t in text_cg)
            else:
                floor = 0.0
            rule = (f" (floor {floor})" if floor else "")
            checks["history within twice textbook f32 CG's distance from "
                   "float64" + rule] = got[0] <= max(2 * text_cg[0], floor)
            checks["x within twice textbook f32 CG's distance from float64"
                   + rule] = got[1] <= max(2 * text_cg[1], floor)
        elif kind == "bicg":
            # (max rel dev over the window, leading finite entries)
            dev_k = rel_dev(hist[:win32], b64[:win32])
            res.update(window=win32,
                       agree=agree_window(hist, b64, FLAT_BICG_RTOL),
                       vs_f64={"kernel": (dev_k.max().item(), finite_window(
                           torch, hist.double(), b64)),
                           "textbook f32": text_bi})
            checks[f"within {FLAT_BICG_RTOL} of float64 over the {win32} "
                   "entries where textbook f32 is within a tenth of it"] = \
                bool((dev_k <= FLAT_BICG_RTOL).all()) and win32 >= 2
        else:
            h = hist.double()
            rise = (h[1:] / h[:-1]).max().item()
            res["largest_rise"] = rise - 1
            checks[f"non-increasing within {GMRES_SLACK}"] = \
                rise <= 1 + GMRES_SLACK
        bad = [k for k, ok in checks.items() if not ok]
        failed += [f"flat1d {name}: {k}" for k in bad]
        res["checks"] = checks
        results[name] = res
        for m, c in counts.items():
            launches[m] = launches.get(m, 0) + c
            grid_launches[m] = grid_launches.get(m, 0) + c / pieces
        log(f"[flat1d] {name} solve({iters}) at n = {N_FLAT} (view "
            f"{list(FLAT_GRID)}, {pieces} piece{'s' if pieces > 1 else ''}): "
            f"launches {counts}; residual^2 {hist[0].item():.6g} -> "
            f"{hist[-1].item():.6g}; "
            + ", ".join(f"{k} {a:.3g} {b:.3g}" for k, (a, b) in
                        res.get("vs_f64", {}).items())
            + (f"; checks FAILED: {bad}" if bad else "; checks hold"))
        del x
    for n in FLAT_ACC_SIZES:
        env = sstep_accuracy_1d(torch, T, lt, device, n)
        k_env, t_env = env["kernel"], env["textbook f32"]
        env["bound"] = tuple(max(2 * t, X_F64_FLOOR) for t in t_env)
        ok = k_env[0] <= env["bound"][0] and k_env[1] <= env["bound"][1]
        rule = ("history and x within twice textbook f32 CG's distance "
                f"from float64 (floor {X_F64_FLOOR})")
        if not ok:
            failed.append(f"flat1d s-step CG at n = {n}: {rule}")
        results[f"s-step CG at {n}"] = {"vs_f64": env, "checks": {rule: ok}}
        log(f"[flat1d] s-step CG solve({N_ITERS}) at n = {n}, against "
            "float64 CG (history, x max rel): " + ", ".join(
                f"{k} {h:.3g} {xx:.3g}" for k, (h, xx) in env.items())
            + ("; checks hold" if ok else "; checks FAILED"))
    return launches, grid_launches, results, solvers, failed


def time_flat1d(torch, T, TB, device, bw, card, solvers):
    """Phase 5l.  Each 1-D route at full width ([4096, 4096]) with CUDA
    events over a ring of three input sets, beside its plain version and
    in CUDA graphs; the wide terms (:func:`wide_kw`) of K3, K4 and K5 (the
    band route) at 4096^2 the same way; each FLAT_RUNS solve's ms/iter and
    host enqueue ms/iter (:func:`solve_ms`) and its idle share, 1 - its
    device time (a torch.profiler trace) over its wall.  Returns
    ({pass: (ms, plain ms, graph ms)} of the flat route, the same of the
    wide terms, {run: times})."""
    n = N_FLAT
    out = {}
    for st, kw in (("flat", flat_kw(T, FLAT_C)), ("wide", wide_kw(FLAT_C))):
        ring = [flat_inputs(torch, T, FLAT_GRID, s, device, True, kw)
                for s in range(3)]
        modes = [m for m in KERNELS if st == "flat" or m in ONE_PASS_NAMES]
        for mode in modes:
            fns = {plain: [kernel_call(T, mode, d, plain, kw) for d in ring]
                   for plain in (False, True)}
            k = iter(range(10**9))
            ms = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
            plain_ms = event_ms(torch, lambda: fns[True][next(k) % 3](), 6)
            g = graph_ms(torch, fns[False], 30)
            sane(f"{mode} {st}", ms, KERNELS[mode][2] * n, bw)
            out[mode, st] = (ms, plain_ms, g)
        del ring
        bring = [bicg_inputs(torch, FLAT_GRID, 40 + s, device)
                 for s in range(3)]
        for d in bring:
            d["alpha"] = d["alpha"] * 1e-3
            d["p_out"], d["v_out"], d["r_out"] = (torch.empty_like(d["r"])
                                                  for _ in range(3))
        for name, (_, bpe) in BICG_KERNELS.items():
            fns = {plain: [bicg_call(TB, name, d, False, plain, out=(
                d["p_out"], d["v_out"]) if name == "bicg_pv" else d["r_out"],
                kw=kw) for d in bring] for plain in (False, True)}
            k = iter(range(10**9))
            ms = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
            plain_ms = event_ms(torch, lambda: fns[True][next(k) % 3](), 6)
            g = graph_ms(torch, fns[False], 30)
            sane(f"{name} {st}", ms, bpe * n, bw)
            out[name, st] = (ms, plain_ms, g)
        if st == "flat":  # K5b on the band march, beside its flat march
            fns = [bicg_call(TB, "bicg_st", d, False, False, kw=kw)
                   for d in bring]
            k = iter(range(10**9))
            with forced_routes(TB, ("st",), kind="band"):
                out["bicg_st band", st] = (
                    event_ms(torch, lambda: fns[next(k) % 3](), 30),
                    out["bicg_st", st][1], graph_ms(torch, fns, 30))
        del bring
        for m in [*modes, *BICG_KERNELS] + (["bicg_st band"]
                                            if st == "flat" else []):
            ms, plain_ms, g = out[m, st]
            log(f"[time] {st} {m:11s} kernel {ms:.4f} ms (CUDA graphs "
                f"{g:.4f}), plain {plain_ms:.4f} ms at [{FLAT_C}, {FLAT_C}]"
                f" f32 on {card}")
    solves = {}
    for name, solver in solvers.items():
        kind, env, pieces, iters, _ = FLAT_RUNS[name]
        # the solves on pieces are host-bound (some 30-150 glue ops per
        # iteration): a tenth of them is traced, as 5j traces such solves
        n = iters if pieces == 1 else iters // 10
        with env_route(env, solver):
            ms, host = solve_ms(torch, solver, iters)
            dev = profile_solve(torch, solver, "flat1d_" + name.replace(
                " ", "_").replace("(", "").replace(")", ""), card,
                ms * n / iters, n_iters=n)
        solves[name] = {"ms/iter": ms / iters, "host ms/iter": host / iters,
                        "device ms/iter": dev / n,
                        "idle": 1 - dev / n / (ms / iters)}
        r = solves[name]
        per = "cycle" if kind == "gmres" else "iteration"
        log(f"[time] 1-D {name} solve({iters}) at n = {N_FLAT}: "
            f"{r['ms/iter']:.4f} ms per {per} (host enqueue "
            f"{r['host ms/iter']:.4f}, device {r['device ms/iter']:.4f} over "
            f"{n} traced, idle {100 * r['idle']:.1f}%) on {card}")
    return ({m: v for (m, st), v in out.items() if st == "flat"},
            {m: v for (m, st), v in out.items() if st == "wide"}, solves)


def library_1d(torch, T, device, card):
    """F.conv1d computing K3's y on the 1-D view (cuDNN, TF32 off): the
    3-point Laplacian of a 2^24 vector, held to the kernel's flat route;
    ms over a ring of three inputs."""
    import torch.nn.functional as F

    w = torch.zeros(1, 1, 3, device=device)
    for d, v in zip(*LAP1):
        w[0, 0, 1 + d] = v
    g = torch.Generator(device=device).manual_seed(62)
    ring = [torch.randn(FLAT_GRID, generator=g, device=device)
            for _ in range(3)]
    y_ker = T.grid2d_stencil_matvec(ring[0], **flat_kw(T, FLAT_C))
    y_lib = F.conv1d(ring[0].reshape(1, 1, -1), w, padding=1)
    err = (y_lib.reshape(FLAT_GRID) - y_ker).abs().max().item()
    if err > 1e-5 * y_ker.abs().max().item():
        raise AssertionError(f"F.conv1d disagrees with K3 y: {err:g}")
    k = iter(range(10**9))
    ms = event_ms(torch, lambda: F.conv1d(
        ring[next(k) % 3].reshape(1, 1, -1), w, padding=1), 30)
    log(f"[time] F.conv1d y: {ms:.4f} ms (max abs diff from K3 y on the "
        f"1-D view {err:.3g}) at n = {N_FLAT} f32 on {card}")
    return ms


FLAT_CSRC = "legionsolvers_tpu_torch/csrc/flat1d.cu"
# launches per solve(200) on the 1-D view: the s-step CG's K1 and K2 (the
# flat march), and a two-pass CG's and a BiCGStab's passes, which the wide
# stencil (wide_kw) would launch as often
SSTEP_200 = FLAT_RUNS["s-step CG"][4]
WIDE_200 = {"pq": 1, "update": N_ITERS, "xpay_pq": N_ITERS - 1,
            **{m: N_ITERS for m in BICG_KERNELS}}


def flat_attrs(lib):
    """{pass: [registers, spill bytes, resident blocks per SM, static
    shared memory bytes]} of K1's, K2's and K5b's (f32 dots) flat kernels
    with 16-byte loads (cudaFuncGetAttributes and the occupancy calculator
    on this card), or {} for a tree without them (``--tree`` of an older
    tree)."""
    import ctypes

    if not hasattr(lib, "ls_flat_attrs"):
        return {}
    out, res = (ctypes.c_int * 4)(), {}
    for m, which in (("step2", 1), ("gram2", 3), ("bicg_st", 5)):
        err = lib.ls_flat_attrs(which, out)
        if err and m == "bicg_st" and not hasattr(lib, "ls_flat_bicg_st"):
            continue  # a tree from before K5b's flat march
        if err:
            raise RuntimeError(f"ls_flat_attrs({which}): CUDA error {err}")
        res[m] = list(out)
        log(f"[flat1d] {m} flat march (vec): {out[0]} registers, {out[1]} B "
            f"spilled, {out[2]} blocks per SM, {out[3]} B shared memory")
    return res


def flat1d_rows(T, launches, grid_launches, errs, times, bw, conv1d_ms,
                attrs=None, wide_times=None):
    """The kernels line's rows of the 1-D view's routes: launches from
    phase 4l's solves, times from phase 5l at [4096, 4096]; K3 y's
    library_ms is ``conv1d_ms`` (:func:`library_1d`), the other passes
    have no one library call.  K1 and K2 (the flat march) also get their
    registers, spill, blocks per SM and shared memory (``attrs``,
    :func:`flat_attrs`) and their ms lost per s-step solve(200); each pass
    with the wide stencil (``wide_times``) its bound (the flat row's
    bytes), % of bound and ms lost over WIDE_200's launches."""
    rows = []
    for m in (*KERNELS, *BICG_KERNELS):
        if m in KERNELS:
            wrapper, line, bpe = KERNELS[m]
            source, replaces = CSRC, f"{PALLAS}:{line}"
            name = f"{wrapper} [{m}] 1-D view"
        else:
            line, bpe = BICG_KERNELS[m]
            replaces = f"{BICG_PALLAS}:{line}"
            name = f"{m} 1-D view"
        route = "flat"
        if m in BICG_KERNELS:
            # K5a and K5c have no strip kernel: the band march
            route, source = k5_route(T, m, flat_kw(T, FLAT_C), FLAT_C)
        if m in SSTEP_200 or route == "flat":
            source, route = FLAT_CSRC, "flat march"
        ms, plain_ms, g = times[m]
        row = kernel_row(name, source, replaces, launches.get(m, 0), errs[m],
                         ms, plain_ms, bpe * N_FLAT,
                         ops_per_elt(m, len(LAP1[0])) * N_FLAT, bw,
                         conv1d_ms if m == "y" else None,
                         grid_launches=grid_launches.get(m, 0))
        row.update(graph_ms=g, kernel_route=route)
        if m == "bicg_st" and "bicg_st band" in times:
            row["band_ms"], _, row["band_graph_ms"] = times["bicg_st band"]
        extra = ""
        if route == "flat march":
            per = SSTEP_200.get(m, N_ITERS)
            row["ms_lost_per_solve200"] = per * (ms - row["bound_ms"])
            row["graph_ms_lost_per_solve200"] = per * (g - row["bound_ms"])
            extra = (f", {row['ms_lost_per_solve200']:.2f} ms lost per "
                     f"{'s-step CG' if m in SSTEP_200 else 'BiCGStab'} "
                     f"solve(200) ({row['graph_ms_lost_per_solve200']:.2f} "
                     "in graphs)")
            if attrs and m in attrs:
                regs, spill, per_sm, smem = attrs[m]
                row.update(registers=regs, spill_bytes=spill,
                           blocks_per_sm=per_sm, shared_memory_bytes=smem)
                extra += (f", {regs} registers, {spill} B spilled, {per_sm} "
                          f"blocks per SM, {smem} B shared")
        rows.append(row)
        log(f"[time] 1-D view {m:11s} ({route} route) {ms:.4f} ms (graphs "
            f"{g:.4f}), bound {row['bound_ms']:.4f} "
            f"({row['pct_of_bound']:.1f}%), launches {row['launches']} at "
            f"[{FLAT_C}, {FLAT_C}]{extra}")
        if wide_times and m in wide_times:
            wms, _, wg = wide_times[m]
            row.update(wide_ms=wms, wide_graph_ms=wg,
                       wide_pct_of_bound=100 * row["bound_ms"] / wms,
                       wide_ms_lost_per_solve200=WIDE_200.get(m, 0) * (
                           wms - row["bound_ms"]))
            wroute = (k5_route(T, m, wide_kw(FLAT_C), FLAT_C)[0]
                      if m in BICG_KERNELS else "band")
            row["wide_route"] = wroute
            log(f"[time] 1-D view {m:11s} wide terms ({wroute}) {wms:.4f} ms "
                f"(graphs {wg:.4f}), bound {row['bound_ms']:.4f} "
                f"({row['wide_pct_of_bound']:.1f}%), "
                f"{WIDE_200.get(m, 0)} launches per two-pass CG or BiCGStab "
                f"solve(200): {row['wide_ms_lost_per_solve200']:.2f} ms lost")
    return rows


# ---------------------------------------------------------------------------
# phase 4m: wide z shifts on the 3-D kernels (kernel item C) and K1's nop
# mode (item D); phase 5m: their times
# ---------------------------------------------------------------------------

# S_wide: the 7-point cross (center 8.5), (0, 0, +-12) just past the
# window's 8, (0, +-3, +-100) wide in z and off-row in y, and (+-1, 0,
# +-128), a neighbour plane at |oz| = 128 (JAX's PADZ); symmetric and
# diagonally dominant (8.5 = 6 + 1 + 1 + 0.5)
WIDE3 = (((0, 0, 0), 8.5), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
         ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
         ((0, 0, 1), -1.0), ((0, 0, -12), -0.5), ((0, 0, 12), -0.5),
         ((0, 3, 100), -0.25), ((0, -3, -100), -0.25),
         ((0, 3, -100), -0.25), ((0, -3, 100), -0.25),
         ((1, 0, 128), -0.25), ((-1, 0, -128), -0.25))
WIDE3_KW = dict(offsets=tuple(o for o, _ in WIDE3),
                values=tuple(v for _, v in WIDE3))
# Z not a multiple of 128 (and Z % 4 != 0), X = 1 with Y < 8, |oz| = Z - 1
# (Z = 129), 17 planes (window chunks of 4, 4, 4, 4 and 1)
WIDE3_EDGES = ((37, 45, 130), (1, 5, 301), (20, 7, 129), (17, 9, 256))
WIDE3_PASSES = (*KERNELS3, *BICG3_KERNELS)
WIDE3_PIECES = 4
WIDE3_STEP_ITERS = 20  # BiCGStab step() on pieces
# name -> (solver, pieces, compensated dots, solve length, launches);
# GMRES(10) solves GMRES_CYCLES cycles (a residual and ten Arnoldi
# matvecs each, and the residual of the last x)
WIDE3_RUNS = {
    "two-pass CG": ("cg", 1, False, N_ITERS, SOLVE3_LAUNCHES["cg"]),
    "BiCGStab": ("bicg", 1, False, N_ITERS, SOLVE3_LAUNCHES["bicg"]),
    "BiCGStab compensated": ("bicg", 1, True, N_ITERS,
                             SOLVE3_LAUNCHES["bicg"]),
    "PCG": ("pcg", 1, False, N_ITERS, {"y_dot3d": N_ITERS}),
    "GMRES(10)": ("gmres", 1, False, GMRES_CYCLES,
                  {"y3d": 11 * GMRES_CYCLES + 1}),
    "CG 4 pieces": ("cg", WIDE3_PIECES, False, N_ITERS, {
        m: WIDE3_PIECES * c for m, c in SOLVE3_LAUNCHES["cg"].items()}),
    "BiCGStab step() 4 pieces": ("bicg", WIDE3_PIECES, False,
                                 WIDE3_STEP_ITERS, {
                                     "y3d": WIDE3_PIECES * WIDE3_STEP_ITERS,
                                     "y_dot3d": WIDE3_PIECES
                                     * WIDE3_STEP_ITERS}),
}
# f32 CG on S_wide reaches f32's floor within ~40 iterations (float64 CG
# goes on falling, by 1e-70 at 200), so the CG solves are held to twice
# textbook f32 CG's distance from float64 (floor CG3_F64_FLOOR, phase 4c's
# rule) over the entries where textbook f32 stays within WIDE3_CG_WINDOW
# of float64, and x over the whole solve; BiCGStab within FLAT_BICG_RTOL
# over the entries where textbook f32 stays within a tenth of that
WIDE3_CG_WINDOW = 1e-3
NOP_SHAPES = ((N_GRID, N_GRID), RAGGED, (33, 4097), (1, 5))


def terms_matvec(torch, terms):
    """y = A v for the stencil ``terms`` ({offset: value}, 2-D or 3-D) by
    shifted slices of a copy of v zero-padded by each axis' reach: the
    references' own matvec, any dtype."""
    import torch.nn.functional as F

    h = [max(abs(o[a]) for o, _ in terms) for a in range(len(terms[0][0]))]
    pad = [p for r in reversed(h) for p in (r, r)]

    def A(v):
        e = F.pad(v, pad)
        out = torch.zeros_like(v)
        for off, w in terms:
            out += w * e[tuple(slice(r + o, r + o + n)
                               for r, o, n in zip(h, off, v.shape))]
        return out

    return A


def textbook_pcg(torch, shape, iters, dtype, device, matvec, diag):
    """Textbook PCG on ``matvec`` with the Jacobi preconditioner of the
    constant diagonal ``diag`` (z = r times 1 / diag rounded to ``dtype``),
    b = 1, x0 = 0, in ``dtype`` on ``device``: (history of <r, r>, x),
    both float64."""
    inv = torch.tensor(1.0 / diag, dtype=dtype, device=device)
    b = torch.ones(shape, dtype=dtype, device=device)
    x, r = b * 0, b * 1
    z = r * inv
    p, rz = z * 1, (r * z).sum()
    hist = [(r * r).sum()]
    for _ in range(iters):
        q = matvec(p)
        a = rz / (p * q).sum()
        x += a * p
        r -= a * q
        z = r * inv
        rz_new = (r * z).sum()
        hist.append((r * r).sum())
        p = z + (rz_new / rz) * p
        rz = rz_new
    return torch.stack(hist).double(), x.double()


def compare_wide3d_kernels(torch, T3, TB3, device):
    """Phase 4m, the kernels: K6a's four modes, K6b and K7 pv, st and
    update (compensated dots off and on) with S_wide against their plain
    versions at 256^3 and WIDE3_EDGES, random halo planes: phase 3c's
    bounds (elementwise 1e-5 * max|ref|, dots 1e-4 of their Cauchy-Schwarz
    scale) and a repeat on the same inputs bit for bit.  Returns {pass:
    max abs error} (K7: the larger of both dot modes)."""
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = {}
    for name in WIDE3_PASSES:
        if T3.route3d(name, WIDE3_KW["offsets"]) != "window":
            raise AssertionError(f"{name} with S_wide is off the window "
                                 "march")
    for shape in (SHAPE3, *WIDE3_EDGES):
        if not T3.supports3d(*shape, WIDE3_KW["offsets"]):
            raise AssertionError(f"S_wide off the kernels' gate at {shape}")
        d = inputs3d(torch, shape, 61, device)
        worst = 0.0
        for name in WIDE3_PASSES:
            for comp in ((False, True) if name in BICG3_KERNELS
                         else (False,)):
                outs = []
                for plain in (False, False, True):
                    c = {k: v.clone() for k, v in d.items()}
                    res = call3d(T3, TB3, name, c, WIDE3_KW, plain, comp)()
                    outs.append(dict(zip(NAMES3[name], res)))
                got, again, ref = outs
                torch.cuda.synchronize()
                case = f"{name} {shape} compensated={comp}"
                if not all(same_bits(got[k], again[k]) for k in got):
                    raise AssertionError(f"{case}: a repeat is not "
                                         "bit-identical")
                ops = dot_operands3(T3, name, d, ref, WIDE3_KW)
                for key, want in ref.items():
                    err = (got[key].double() - want.double()).abs().max()
                    if want.dim():
                        ok = err.item() <= 1e-5 * want.abs().max().item()
                    else:
                        a, b = ops[key]
                        ok = err.item() <= 1e-4 * nrm(a) * nrm(b)
                    if not ok:
                        raise AssertionError(
                            f"{case} {key}: kernel disagrees with its plain "
                            f"version (max abs err {err.item():g})")
                    errs[name] = max(errs.get(name, 0.0), err.item())
                    worst = max(worst, err.item())
        log(f"[wide3d] {shape}: K6a (4 modes), K6b, K7 (compensated off, "
            f"on) with S_wide == plain (max abs err {worst:.3g}); repeats "
            "bit for bit")
        del d
    return errs


def compare_nop(torch, T, device):
    """Phase 4m: K1's nop mode against its plain version at NOP_SHAPES:
    x'', r'', p'' bit for bit (one f32 add, or none), g[0] within 1e-5 of
    its Cauchy-Schwarz scale, g[1..9] zero, a repeat bit for bit.
    Returns the max abs error of g[0]."""
    worst = 0.0
    for shape in NOP_SHAPES:
        d = one_pass_inputs(torch, shape, False, device, 67)
        coef = torch.full((6,), 0.25, device=device)
        runs = []
        for fn in (T._grid2d_cg_nop, T._grid2d_cg_nop, T.nop_plain):
            c = {k: d[k].clone() for k in ("x", "r", "p")}
            runs.append(fn(c["x"], c["r"], c["p"], coef, **KW))
        torch.cuda.synchronize()
        k1, k2, ref = runs
        scale = (torch.linalg.vector_norm(d["r"].double())
                 * torch.linalg.vector_norm(d["p"].double())).item()
        err = abs(k1[3][0].item() - ref[3][0].item())
        ok = (all(same_bits(a, b) for a, b in zip(k1, k2))
              and all(same_bits(a, b) for a, b in zip(k1[:3], ref[:3]))
              and err <= 1e-5 * scale and not k1[3][1:].any())
        if not ok:
            raise AssertionError(f"K1 nop at {shape} disagrees with its "
                                 f"plain version (g[0] err {err:g})")
        worst = max(worst, err)
    log(f"[nop] K1 nop == plain at {list(NOP_SHAPES)} (x'', r'', p'' bit for "
        f"bit, g[0] max abs err {worst:.3g}); repeats bit for bit")
    return worst


def wide3d_path(torch, T, T3, TB3, lt, device):
    """Phase 4m, the solves: ``entry.build_stencil_system(3, (256,)*3,
    stencil=S_wide)`` on one piece and on 4 pieces of the card, each
    WIDE3_RUNS solve from x0 = 0 with its launches counted exactly (counts
    set to 0 just before it, read just after), no plain version called,
    the operator on the 3-D view (Br 256, or 64 on 4 pieces), a repeat
    from the same state bit for bit.  CG (one piece, 4 pieces) within
    twice textbook f32 CG's distance from float64 CG over the entries
    where textbook f32 stays within WIDE3_CG_WINDOW of it, and x over the
    solve (floor CG3_F64_FLOOR); PCG (CG in exact arithmetic: the diagonal
    is constant) the same against textbook f32 PCG; BiCGStab within FLAT_BICG_RTOL of
    float64 BiCGStab over the entries where textbook f32 stays within a
    tenth of that; GMRES(10) non-increasing within GMRES_SLACK.  Returns
    (launches by pass, whole-grid launches by pass, results, {run:
    solver}, failed)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    A = terms_matvec(torch, WIDE3)
    h64, x64 = classic_cg(torch, SHAPE3, N_ITERS, torch.float64, device, A)
    h32, x32 = classic_cg(torch, SHAPE3, N_ITERS, torch.float32, device, A)
    b64, _ = textbook_bicgstab(torch, SHAPE3, N_ITERS, torch.float64, device,
                               matvec=A)
    b32, _ = textbook_bicgstab(torch, SHAPE3, N_ITERS, torch.float32, device,
                               matvec=A)
    # PCG's Jacobi scaling by 1 / 8.5 rounds in f32 (the 1-D view's by
    # 1 / 2 does not), so PCG has its own textbook f32 twin
    c32, cx32 = textbook_pcg(torch, SHAPE3, N_ITERS, torch.float32, device,
                             A, WIDE3[0][1])
    text = {}
    for kind, (h, xx) in (("cg", (h32, x32)), ("pcg", (c32, cx32))):
        w = agree_window(h, h64, WIDE3_CG_WINDOW)
        text[kind] = (w, (rel_dev(h[:w], h64[:w]).max().item(),
                          x_rel(xx, x64)))
    wbi = agree_window(b32, b64, FLAT_BICG_RTOL / 10)
    del x32, cx32
    launches, grid_launches, results, solvers, failed = {}, {}, {}, {}, []
    for name, (kind, pieces, comp, iters, want) in WIDE3_RUNS.items():
        mesh = (make_mesh(pieces, devices=[device] * pieces) if pieces > 1
                else None)
        opts = lt.SolverOptions(entry_dtype=torch.float32,
                                compensated_dots=comp)
        planner = build_stencil_system(3, SHAPE3, opts, device, mesh=mesh,
                                       stencil=list(WIDE3))
        op = planner.row_partitioned_matrices[0][0]
        v = op._view
        solver = flat_solver(lt, planner, kind)
        with counted_calls(plain_names(T3, TB3), solver) as plain:
            view_ok = (op.uses_pallas and v["kind"] == "3d"
                       and v["Br"] * pieces == SHAPE3[0]
                       and op.supports_fused_bicgstab == (pieces == 1))
            hist, x, counts = counted_solve(torch, T, solver, iters)
            hist2, x2, _ = counted_solve(torch, T, solver, iters)
        solvers[name] = solver
        checks = {"on the 3-D view": view_ok,
                  f"launches {want}": counts == want,
                  "no plain version called": not plain.calls,
                  "a repeat from the same state is bit-identical":
                      same_bits(hist, hist2) and same_bits(x, x2)}
        del x2
        res = {"launches": counts, "plain_calls": dict(plain.calls),
               "hist_first_last": (hist[0].item(), hist[-1].item())}
        if kind in ("cg", "pcg"):
            wcg, text_cg = text[kind]
            got = (rel_dev(hist[:wcg], h64[:wcg]).max().item(),
                   x_rel(x, x64))
            res["vs_f64"] = {"kernel": got, f"textbook f32 {kind}": text_cg}
            res["window"] = wcg
            checks["finite history"] = bool(torch.isfinite(hist).all())
            checks[f"history (first {wcg} entries) and x within twice "
                   f"textbook f32 {kind.upper()}'s distance from float64 "
                   f"CG (floor {CG3_F64_FLOOR})"] = (
                got[0] <= max(2 * text_cg[0], CG3_F64_FLOOR)
                and got[1] <= max(2 * text_cg[1], CG3_F64_FLOOR)
                and wcg >= 2)
        elif kind == "bicg":
            n = min(wbi, len(hist))
            dev_k = rel_dev(hist[:n], b64[:n])
            res.update(window=n, agree=agree_window(hist, b64[:len(hist)],
                                                    FLAT_BICG_RTOL),
                       vs_f64={"kernel": dev_k.max().item(), "textbook f32":
                               rel_dev(b32[:n], b64[:n]).max().item()})
            checks[f"within {FLAT_BICG_RTOL} of float64 over the {n} "
                   "entries where textbook f32 is within a tenth of it"] = \
                bool((dev_k <= FLAT_BICG_RTOL).all()) and n >= 2
        else:
            h = hist.double()
            rise = (h[1:] / h[:-1]).max().item()
            res["largest_rise"] = rise - 1
            checks["finite history"] = bool(torch.isfinite(hist).all())
            checks[f"non-increasing within {GMRES_SLACK}"] = \
                rise <= 1 + GMRES_SLACK
        bad = [k for k, ok in checks.items() if not ok]
        failed += [f"wide3d {name}: {k}" for k in bad]
        res["checks"] = checks
        results[name] = res
        for m, c in counts.items():
            launches[m] = launches.get(m, 0) + c
            grid_launches[m] = grid_launches.get(m, 0) + c / pieces
        log(f"[wide3d] {name} solve({iters}) with S_wide at 256^3 "
            f"({pieces} piece{'s' if pieces > 1 else ''}): launches "
            f"{counts}; residual^2 {hist[0].item():.6g} -> "
            f"{hist[-1].item():.6g}; "
            + "".join(f"{k} {res[k]}; " for k in ("vs_f64", "window")
                      if k in res)
            + (f"checks FAILED: {bad}" if bad else "checks hold"))
        del x
    return launches, grid_launches, results, solvers, failed


def time_wide3d(torch, T3, TB3, device, bw, card, solvers):
    """Phase 5m.  Each wide-z pass at 256^3 (S_wide, no halo planes, as the
    one-piece solves call them) with CUDA events over a ring of three
    input sets, in CUDA graphs, and beside its plain version (K7 with
    compensated dots off and on); each WIDE3_RUNS solve's ms/iter, host
    enqueue and idle share (a torch.profiler trace).  Returns ({(pass,
    compensated): (ms, plain ms, graph ms)}, {run: times})."""
    n = SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
    ring = [inputs3d(torch, SHAPE3, 80 + s, device) for s in range(3)]
    for d in ring:
        d["alpha"] = d["alpha"] * 1e-3  # keep the in-place x, r bounded
        d["top"] = d["bot"] = None
        d["o1"], d["o2"] = torch.empty_like(d["x"]), torch.empty_like(d["x"])
    out = {}
    for name in WIDE3_PASSES:
        bpe = (KERNELS3[name][2] if name in KERNELS3
               else BICG3_KERNELS[name][1])
        for comp in ((False, True) if name in BICG3_KERNELS else (False,)):
            fns = {plain: [call3d(T3, TB3, name, d, WIDE3_KW, plain, comp,
                                  out=((d["o1"], d["o2"])
                                       if name == "bicg3d_pv" else d["o1"]))
                           for d in ring] for plain in (False, True)}
            k = iter(range(10**9))
            ms = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
            plain_ms = event_ms(torch, lambda: fns[True][next(k) % 3](), 6)
            g = graph_ms(torch, fns[False], 30)
            sane(f"{name} wide", ms, bpe * n, bw)
            out[name, comp] = (ms, plain_ms, g)
            log(f"[time] wide z {name:13s} compensated={comp!s:5s} kernel "
                f"{ms:.4f} ms (CUDA graphs {g:.4f}), plain {plain_ms:.4f} ms "
                f"at 256^3 f32 on {card}")
    del ring
    times = {}
    for name, solver in solvers.items():
        kind, pieces, _, iters, _ = WIDE3_RUNS[name]
        ms, host = solve_ms(torch, solver, iters)
        label = "wide3d_" + "".join(c if c.isalnum() else "_" for c in name)
        dev = profile_solve(torch, solver, label, card, ms, n_iters=iters)
        times[name] = {"ms/iter": ms / iters, "host ms/iter": host / iters,
                       "device ms/iter": dev / iters,
                       "idle": 1 - dev / ms}
        r = times[name]
        per = "cycle" if kind == "gmres" else "iteration"
        log(f"[time] wide z {name} solve({iters}) at 256^3: "
            f"{r['ms/iter']:.4f} ms per {per} (host enqueue "
            f"{r['host ms/iter']:.4f}, device {r['device ms/iter']:.4f}, "
            f"idle {100 * r['idle']:.1f}%) on {card}")
    return out, times


def library_wide3d(torch, T3, device, card):
    """F.conv3d over S_wide's dense (3, 7, 257) box (cuDNN, TF32 off; the
    smallest box holding its terms, zero weights elsewhere) computing K6a
    y at 256^3, held to the kernel's y: (ms over a ring of three inputs,
    None and the reason where cuDNN cannot run it)."""
    import torch.nn.functional as F

    h = [max(abs(o[a]) for o in WIDE3_KW["offsets"]) for a in range(3)]
    w = torch.zeros(1, 1, *(2 * r + 1 for r in h), device=device)
    for (ox, oy, oz), v in WIDE3:
        w[0, 0, h[0] + ox, h[1] + oy, h[2] + oz] = v
    g = torch.Generator(device=device).manual_seed(63)
    ring = [torch.randn(SHAPE3, generator=g, device=device) for _ in range(3)]
    conv = [lambda x=x: F.conv3d(x[None, None], w, padding=tuple(h))
            for x in ring]
    try:
        y_lib = conv[0]()[0, 0]
        torch.cuda.synchronize()
    except RuntimeError as e:
        why = str(e).splitlines()[0]
        log(f"[time] F.conv3d over S_wide's {tuple(w.shape[2:])} box: does "
            f"not run ({why}) on {card}")
        return None, why
    y_ker = T3.grid3d_stencil_matvec(ring[0], **WIDE3_KW)
    err = (y_lib - y_ker).abs().max().item()
    if err > 1e-5 * y_ker.abs().max().item():
        raise AssertionError(f"F.conv3d disagrees with K6a y: {err:g}")
    k = iter(range(10**9))
    ms = event_ms(torch, lambda: conv[next(k) % 3](), 3)
    log(f"[time] F.conv3d y over S_wide's {tuple(w.shape[2:])} box: "
        f"{ms:.4f} ms (max abs diff from K6a y {err:.3g}) at 256^3 f32 on "
        f"{card}")
    return ms, None


def time_nop(torch, T, device, bw, card):
    """Phase 5h: K1 nop and K1 step2 at 4096^2 with CUDA events over a
    ring of three input sets and in CUDA graphs, and nop's plain version.
    Returns {"nop" | "step2": (ms, plain ms, graph ms)}."""
    n = N_GRID * N_GRID
    ring = [flat_inputs(torch, T, (N_GRID, N_GRID), 90 + s, device, False,
                        KW) for s in range(3)]
    for d in ring:
        d["ro"], d["po"] = torch.empty_like(d["r"]), torch.empty_like(d["p"])
    calls = {"nop": (T._grid2d_cg_nop, T.nop_plain),
             "step2": (T.grid2d_cg_step2, T.step2_plain)}
    out = {}
    for m, (fn, plain_fn) in calls.items():
        fns = [lambda d=d, f=fn: f(d["x"], d["r"], d["p"], d["coef"],
                                   out=(d["ro"], d["po"]), **KW)
               for d in ring]
        pfns = [lambda d=d, f=plain_fn: f(d["x"], d["r"], d["p"], d["coef"],
                                          out=(d["ro"], d["po"]), **KW)
                for d in ring]
        k = iter(range(10**9))
        ms = event_ms(torch, lambda: fns[next(k) % 3](), 30)
        plain_ms = event_ms(torch, lambda: pfns[next(k) % 3](), 6)
        g = graph_ms(torch, fns, 30)
        sane(f"K1 {m}", ms, 24 * n, bw)
        out[m] = (ms, plain_ms, g)
    nop, step2 = out["nop"][2], out["step2"][2]
    log(f"[time] K1 nop {out['nop'][0]:.4f} ms (CUDA graphs {nop:.4f}), "
        f"step2 {out['step2'][0]:.4f} ms (graphs {step2:.4f}); bound "
        f"{24 * n / bw * 1e3:.4f} ms: nop {100 * 24 * n / bw * 1e3 / nop:.1f}"
        f"% of bound in graphs, {100 * nop / step2:.1f}% of step2's time, at "
        f"4096^2 f32 on {card}")
    return out


def wide3d_rows(launches, grid_launches, errs, times, bw, conv_ms,
                conv_why, m3_attrs):
    """The kernels line's rows of the wide-z route: launches from phase
    4m's solves (one piece and 4 pieces), times from phase 5m at 256^3
    (K7: f32 dots; compensated beside them); K6a y's library_ms is the
    dense-box ``F.conv3d`` (None where it does not run); each row's march
    (``kernel_route``), registers, spill bytes, shared memory and blocks
    per SM (:func:`wide3d_attrs`)."""
    n = SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
    rows = []
    for m in WIDE3_PASSES:
        if m in KERNELS3:
            wrapper, line, bpe = KERNELS3[m]
            source, replaces = CSRC3, f"{PALLAS3}:{line}"
            name = f"{wrapper} [{m}] wide z"
        else:
            line, bpe = BICG3_KERNELS[m]
            source, replaces = BICG3_CSRC, f"{BICG3_PALLAS}:{line}"
            name = f"{m} wide z"
        ms, plain_ms, g = times[m, False]
        row = kernel_row(name, source, replaces, launches.get(m, 0),
                         errs[m], ms, plain_ms, bpe * n,
                         ops_per_elt(m, len(WIDE3)) * n, bw,
                         conv_ms if m == "y3d" else None,
                         grid_launches=grid_launches.get(m, 0))
        regs, spill, per_sm, smem = m3_attrs[m][:4]
        row.update(graph_ms=g, registers=regs, spill_bytes=spill,
                   kernel_route="window march", blocks_per_sm=per_sm,
                   shared_memory_bytes=smem)
        if m in BICG3_KERNELS:
            row["compensated_ms"], _, row["compensated_graph_ms"] = \
                times[m, True]
            row["compensated_registers"], row["compensated_spill_bytes"] = \
                m3_attrs[m, True][:2]
        if m == "y3d" and conv_ms is None:
            row["library_note"] = f"F.conv3d does not run: {conv_why}"
        rows.append(row)
        log(f"[time] wide z {m:13s} {ms:.4f} ms (graphs {g:.4f}), bound "
            f"{row['bound_ms']:.4f} ({row['pct_of_bound']:.1f}%), "
            f"{row['kernel_route']}, {regs} registers, {spill} B spilled, "
            f"{per_sm} blocks per SM, launches {row['launches']}, "
            f"{row['ms_lost']:.1f} ms lost at 256^3")
    return rows


def nop_row(err, times, bw):
    """The kernels line's row of K1 nop: no solve calls it (as in JAX), so
    its launches on the main paths are 0; its time from phase 5h."""
    n = N_GRID * N_GRID
    ms, plain_ms, g = times["nop"]
    row = kernel_row("_grid2d_cg_nop [nop]", CSRC,
                     f"{PALLAS}:{KERNELS['step2'][1]}", 0, err, ms, plain_ms,
                     24 * n, 2 * n, bw)
    row.update(graph_ms=g, on_path=False,
               note="diagnostic mode of K1 (step2's I/O, a trivial body); "
                    "no solve calls it, in either package")
    return row


def wide3d_attrs(lib, T3):
    """{pass: attributes} of the window-march kernels, the wide-z route's,
    (pass, True) for K7's with compensated dots, with S_wide at 256^3
    (K6a's four modes, K6b, K7 pv, st and update: registers, spill bytes,
    blocks per SM, dynamic shared memory bytes, blocks), each logged as
    ``[window3d]``."""
    import ctypes

    st = ctypes.byref(T3._stencil3_struct(**WIDE3_KW))
    out = {}
    for m in WIDE3_PASSES:
        for comp in ((False, True) if m in BICG3_KERNELS else (False,)):
            a = (ctypes.c_int * 5)()
            if m in BICG3_KERNELS:
                which = 2 * list(BICG3_KERNELS).index(m) + comp
                err = lib.ls_bicg3d_win_attrs(which, *SHAPE3, st, a)
            else:
                which = list(KERNELS3).index(m)
                err = lib.ls_stencil3d_win_attrs(which, *SHAPE3, st, a)
            if not err:
                log(f"[window3d] {m}{' compensated' if comp else ''} on the "
                    f"window march with S_wide at 256^3: {a[0]} registers, "
                    f"{a[1]} B spilled, {a[3]} B of shared memory, {a[2]} "
                    f"blocks per SM, {a[4]} blocks")
            if err:
                raise RuntimeError(f"attributes of {m} (compensated={comp}): "
                                   f"error {err}")
            out[(m, True) if comp else m] = tuple(a)
    return out


# ---------------------------------------------------------------------------
# phase 4n: "B (general)", K1 and K2 on the general route
# (csrc/sstep_general.cu); phase 5n: their times and the s-step solves'
# ---------------------------------------------------------------------------

GEN_CSRC = "legionsolvers_tpu_torch/csrc/sstep_general.cu"
# S2_gen: the 5-point cross with 7.0 at the centre, (0, +-2) and (0, +-37)
# with -0.5, (+-1, +-100) with -0.25: symmetric, weakly diagonally dominant
# (as ill-conditioned as the Laplacian), |dx| up to 100, within the 120
# that the s-step takes on pieces; S2_4x: -d_xx to fourth order plus -d_yy
# to second order, whose symbol (c - 1)(c - 7) / 3 + 2 - 2 cos ty (c = cos
# tx) is >= 0
S2_GEN = (((0, 0), 7.0), ((-1, 0), -1.0), ((1, 0), -1.0), ((0, -1), -1.0),
          ((0, 1), -1.0), ((0, 2), -0.5), ((0, -2), -0.5), ((0, 37), -0.5),
          ((0, -37), -0.5), ((1, 100), -0.25), ((-1, -100), -0.25),
          ((1, -100), -0.25), ((-1, 100), -0.25))
S2_4X = (((0, 0), 4.5), ((-1, 0), -1.0), ((1, 0), -1.0),
         ((0, -1), -16 / 12), ((0, 1), -16 / 12), ((0, -2), 1 / 12),
         ((0, 2), 1 / 12))
# S2_far: S2_gen with its (+-1, +-100) terms at (+-1, +-200), whose |dx|
# = 200 is past K1's band-march gate at 4096 columns (160) and past the
# s-step's on pieces (120): the cooperative K1's solve, on one piece
S2_FAR = tuple(((dy, 2 * dx if abs(dx) == 100 else dx), v)
               for (dy, dx), v in S2_GEN)
# S2_past: S2_gen with its (+-1, +-100) terms at (+-1, +-1000), on
# GEN_PAST_GRID's 5000 columns past K2's band gate (a ring row of 1000 + 4
# x 1000 floats padded, 5000 clipped to the row, both over 4391), so K2
# runs its cooperative kernel there (and K1, past its own gate, too).  Its
# far terms leave the grid in 40% of the columns, whose rows then
# dominate their diagonal: CG converges fast (float64 residual^2 5.12e6 ->
# 1.58 in 30 iterations, 1e-31 in 200), so its solve runs GEN_ITERS's 34
# iterations (17 K1 passes, a K2 refresh), not N_ITERS, whose tail would
# hold f32 to float64 below f32's floor
GEN_PAST_GRID = (1024, 5000)
S2_PAST = tuple(((dy, 10 * dx if abs(dx) == 100 else dx), v)
                for (dy, dx), v in S2_GEN)
GEN_STENCILS = {"S2_gen": S2_GEN, "S2_4x": S2_4X, "S2_far": S2_FAR,
                "S2_past": S2_PAST}
# each stencil's grid in phase 4n's solves and 5n's times, and the length
# of its solves (N_ITERS but for S2_past)
GEN_GRIDS = {"S2_past": GEN_PAST_GRID}
GEN_ITERS = {"S2_past": 34}
GEN_SSTEP = ("step2", "gram2")
# the kernels line's rows of the general route: (pass, K1 or K2's route,
# the stencil of the row's times, the others timed beside it; the
# cooperative K2 with S2_gen and S2_far at 4096^2 forced off the band
# route it takes there, for the comparison)
GEN_ROWS = (("step2", "general", "S2_gen", ("S2_4x",)),
            ("step2", "general_coop", "S2_far", ()),
            ("gram2", "general", "S2_gen", ("S2_4x", "S2_far")),
            ("gram2", "general_coop", "S2_past", ("S2_gen", "S2_far")))
# K2 passes of an s-step solve(200): the bootstrap and one refresh every
# 16 passes (LEGIONSOLVERS_SSTEP_REFRESH's default) of its 100
GEN_GRAMS = 7
GEN_PIECES = 4
# name -> (stencil, pieces, spaces, launches of one solve(N_ITERS))
GEN_RUNS = {
    "S2_gen one piece": ("S2_gen", 1, 1, {"step2": N_ITERS // 2,
                                          "gram2": GEN_GRAMS}),
    "S2_gen 4 pieces": ("S2_gen", GEN_PIECES, 1, {
        "step2": GEN_PIECES * N_ITERS // 2, "gram2": GEN_PIECES * GEN_GRAMS}),
    "S2_4x one piece": ("S2_4x", 1, 1, {"step2": N_ITERS // 2,
                                        "gram2": GEN_GRAMS}),
    "S2_4x 2-space block": ("S2_4x", 1, 2, {"step2": N_ITERS,
                                            "gram2": 2 * GEN_GRAMS}),
    "S2_far one piece": ("S2_far", 1, 1, {"step2": N_ITERS // 2,
                                          "gram2": GEN_GRAMS}),
    "S2_past one piece": ("S2_past", 1, 1, {"step2": 17, "gram2": 2}),
}
GEN_TIMED_RUNS = ("S2_gen one piece", "S2_gen 4 pieces", "S2_4x one piece",
                  "S2_4x 2-space block")  # 5n's solve times
GEN_F64_FLOOR = 1e-4  # phase 4l's floor of the s-step's distance from f64


def terms_kw(terms):
    return dict(offsets=tuple(o for o, _ in terms),
                values=tuple(v for _, v in terms))


def gen_kw(name, C):
    """The stencil ``name`` of phase 4n at width C: S2_gen, S2_4x,
    S2_far, S2_past (C > 1000), the tile kernels' ``wide(C)`` of the CPU
    tests (its (1, -(C - 1)) spans the gate's width), the cross with (+-1,
    -+(C - 1)), and a stencil with no (0, 0) term."""
    if name in GEN_STENCILS:
        return terms_kw(GEN_STENCILS[name])
    if name == "wide(C)":
        return dict(offsets=OFFS + ((0, 37), (0, -37), (-1, 100),
                                    (1, -(C - 1))),
                    values=(5.0,) + (-1.0,) * 4 + (-0.25, -0.25, -0.5, -0.5))
    if name == "(+-1, -+(C - 1))":
        return dict(offsets=OFFS + ((1, -(C - 1)), (-1, C - 1)),
                    values=(5.0,) + (-1.0,) * 6)
    return dict(offsets=((0, 3), (1, -(C - 1)), (-1, C - 1), (0, -3)),
                values=(1.0, -0.25, -0.25, 1.0))


# (R, C, stencil): C = 128 with (1, -127); |dx| = C - 1 at 4096 (K2's
# window clipped to the row); rows under 8 and C not a multiple of 4 or of
# 128; a ragged row count at C = 4097; no (0, 0) term; S2_far at 4096^2
# (past K1's band gate, inside K2's); S2_past at 5000 columns (past both)
GEN_EDGES = ((16, 128, "wide(C)"), (N_GRID, N_GRID, "(+-1, -+(C - 1))"),
             (5, 130, "S2_4x"), (1, 101, "S2_4x"), (33, 4097, "S2_gen"),
             (7, 130, "no centre"), (N_GRID, N_GRID, "S2_far"),
             (37, 5000, "S2_past"))


# 4n's kernel cases past K1's band gate (K1 on the cooperative kernel),
# and past K2's (K2 on its cooperative kernel)
GEN_COOP_CASES = ((N_GRID, N_GRID, "(+-1, -+(C - 1))"),
                  (N_GRID, N_GRID, "S2_far"), (37, 5000, "S2_past"))
GEN_K2_COOP_CASES = ((37, 5000, "S2_past"),)


def ulps_apart(a, b):
    """Units in the last place between two f32 tensors, entrywise (their
    bit patterns as ordered integers)."""
    import torch

    def ordered(t):
        i = t.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def compare_general_kernels(torch, T, device):
    """Phase 4n, the kernels: K1 and K2 on the general route against
    step2_plain and gram2_plain at 4096^2 with S2_gen and S2_4x and at
    GEN_EDGES, each on the route its gate gives (the pass's band march, or
    its cooperative kernel for GEN_COOP_CASES and GEN_K2_COOP_CASES):
    phase 3's bounds (elementwise 1e-5 * max|ref|, Gram entries 1e-4 of
    their Cauchy-Schwarz scale) and a repeat on the same inputs bit for
    bit; K2's band march also against its cooperative kernel on the same
    inputs, entry by entry in ulps (the same terms in the same order: only
    the Gram's double sums run in another order).  Returns ({(pass,
    route): max abs error}, {case: K2 band against cooperative, the
    largest distance in ulps and the entries that differ})."""
    errs, k2_ulps = {}, {}
    cases = ([(N_GRID, N_GRID, name) for name in ("S2_gen", "S2_4x")]
             + list(GEN_EDGES))
    for R, C, name in cases:
        kw = gen_kw(name, C)
        route = T.route(kw["offsets"], kw["values"], C, sstep=True)[0]
        route2 = T.route(kw["offsets"], kw["values"], C, sstep="gram2")[0]
        want = ("general_coop" if (R, C, name) in GEN_COOP_CASES
                else "general")
        want2 = ("general_coop" if (R, C, name) in GEN_K2_COOP_CASES
                 else "general")
        if (route, route2) != (want, want2):
            raise AssertionError(f"{name} at {(R, C)} takes the {route} "
                                 f"route for K1 and {route2} for K2, not "
                                 f"{want} and {want2}")
        d = flat_inputs(torch, T, (R, C), 71, device, False, kw)
        worst = 0.0
        for mode in ("gram2", "step2"):
            k1, k2, ref = (run_mode(T, mode, d, plain, kw)
                           for plain in (False, False, True))
            torch.cuda.synchronize()
            case = f"{mode} {name} at {(R, C)}"
            if not all(torch.equal(k1[k], k2[k]) for k in k1):
                raise AssertionError(f"{case}: a repeat is not "
                                     "bit-identical")
            for key, want in ref.items():
                err = (k1[key].double() - want.double()).abs()
                if key == "gram":
                    r, p = ((ref["r"], ref["p"]) if mode == "step2"
                            else (d["r"], d["p"]))
                    ok = bool((err.cpu() <= 1e-4 * gram_scales(
                        torch, T, r, p, kw)).all())
                else:
                    ok = err.max().item() <= 1e-5 * want.abs().max().item()
                if not ok:
                    raise AssertionError(
                        f"{case} {key}: kernel disagrees with its plain "
                        f"version ({err.max().item():g})")
                key_r = (mode, route if mode == "step2" else route2)
                errs[key_r] = max(errs.get(key_r, 0.0), err.max().item())
                worst = max(worst, err.max().item())
        vs = ""
        if route2 == "general":
            band = T.grid2d_cg_gram2(d["r"], d["p"], **kw)
            with forced_routes(T, ("gram2",), kind="general_coop"):
                coop = T.grid2d_cg_gram2(d["r"], d["p"], **kw)
            u = ulps_apart(band, coop)
            k2_ulps[f"{name} at {(R, C)}"] = (int(u.max()),
                                              int((u > 0).sum()))
            vs = (f"; K2 band against cooperative: {int((u > 0).sum())} of "
                  f"10 entries differ, at most {int(u.max())} ulp")
        log(f"[general] K2, K1 with {name} at {[R, C]} (routes: K1 "
            f"{route}, K2 {route2}) == plain (max abs err {worst:.3g}); "
            f"repeats bit for bit{vs}")
        del d
    return errs, k2_ulps


def gen_route(name, m="step2"):
    """K1's (``m`` step2) or K2's (gram2) route for 4n's stencil ``name``
    on its grid (GEN_GRIDS; 4096^2 by default)."""
    C = GEN_GRIDS.get(name, (N_GRID, N_GRID))[1]
    kw = gen_kw(name, C)
    from legionsolvers_tpu_torch.ops.cuda.stencil2d import route

    return route(kw["offsets"], kw["values"], C, sstep=m)[0]


_GEN_REFS = {}


def gen_refs(torch, device):
    """{stencil: (float64 CG history, float64 x, textbook f32 CG's
    (history, x) distance from them)} of GEN_STENCILS on their grids
    (GEN_GRIDS; 4096^2 by default), b = 1, x0 = 0, solve(N_ITERS, or
    GEN_ITERS's); made once (phases 4n's s-step and two-pass solves share
    them)."""
    if not _GEN_REFS:
        for name, terms in GEN_STENCILS.items():
            shape = GEN_GRIDS.get(name, (N_GRID, N_GRID))
            iters = GEN_ITERS.get(name, N_ITERS)
            A = terms_matvec(torch, terms)
            h64, x64 = classic_cg(torch, shape, iters, torch.float64,
                                  device, A)
            h32, x32 = classic_cg(torch, shape, iters, torch.float32,
                                  device, A)
            _GEN_REFS[name] = (h64, x64, (rel_dev(h32, h64).max().item(),
                                          x_rel(x32, x64)))
            del x32
    return _GEN_REFS


def general_path(torch, np, T, TB, lt, device):
    """Phase 4n, the solves: ``entry.build_stencil_system(2, (4096,
    4096), stencil=...)`` with S2_gen on one piece and on 4 pieces of the
    card, with S2_4x on one piece and as a 2-space block (b = 1 in both),
    with S2_far on one piece (K1 on the cooperative kernel, K2 on its band
    march), and on GEN_PAST_GRID with S2_past (both on their cooperative
    kernels; solve(34), GEN_ITERS), each CG solve(200) from x0 = 0 on the
    s-step schedule with
    its launches counted exactly (counts set to 0 just before it, read
    just after: K1 and K2 on the general route and nothing of the
    two-pass schedule), no plain version called, a repeat from the same
    state bit for bit, every launch of a third run held to its plain
    version (:class:`shadowed`), and the history and x within twice
    textbook f32 CG's distance from float64 CG on the same system (floor
    GEN_F64_FLOOR, phase 4l's; the block's history against twice one
    space's, its x in both spaces); each logs the margin of its history
    under that bound.  Returns (launches by pass, whole-grid launches by
    pass, results, {run: solver}, failed)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    refs = gen_refs(torch, device)
    launches, grid_launches, results, solvers, failed = {}, {}, {}, {}, []
    for name, (st, pieces, spaces, want) in GEN_RUNS.items():
        shape = GEN_GRIDS.get(st, (N_GRID, N_GRID))
        iters = GEN_ITERS.get(st, N_ITERS)
        mesh = (make_mesh(pieces, devices=[device] * pieces) if pieces > 1
                else None)
        planner = build_stencil_system(2, shape, f32, device,
                                       num_spaces=spaces, mesh=mesh,
                                       stencil=list(GEN_STENCILS[st]))
        op = planner.row_partitioned_matrices[0][0]
        v = op._view
        solver = lt.CGSolver(planner)
        with counted_calls(plain_names(T, TB), solver) as plain:
            view_ok = (op.uses_pallas and v["kind"] == "2d"
                       and v["Br"] * pieces == shape[0]
                       and op.step2_eligible
                       and all(T.route(v["offs"], v["vals"], v["C"],
                                       sstep=m)[0] == gen_route(st, m)
                               for m in GEN_SSTEP))
            hist, x, counts = counted_solve(torch, T, solver, iters)
            xs = [x] + [planner.sol_vectors[s].data.clone()
                        for s in range(1, spaces)]
            hist2, x2, _ = counted_solve(torch, T, solver, iters)
        solvers[name] = solver
        with shadowed(T, solver) as sh:
            restart(solver)
            solver.solve(iters)
            torch.cuda.synchronize()
        T.reset_launch_counts()
        h64, x64, text = refs[st]
        got = (rel_dev(hist, spaces * h64).max().item(),
               max(x_rel(xx, x64) for xx in xs))
        bound = (max(2 * text[0], GEN_F64_FLOOR),
                 max(2 * text[1], GEN_F64_FLOOR))
        rule = f"(floor {GEN_F64_FLOOR})"
        checks = {
            "the s-step on the general route": view_ok,
            f"launches {want}": counts == want,
            "no plain version called": not plain.calls,
            "a repeat from the same state is bit-identical":
                same_bits(hist, hist2) and same_bits(x, x2),
            "every launch within its plain version's bounds":
                not sh.bad and sh.calls == want,
            "finite history": bool(torch.isfinite(hist).all()),
            f"history within twice textbook f32 CG's distance from float64 "
            f"{rule}": got[0] <= bound[0],
            f"x within twice textbook f32 CG's distance from float64 {rule}":
                got[1] <= bound[1]}
        del x2, xs
        bad = [k for k, ok in checks.items() if not ok]
        failed += [f"general {name}: {k}" for k in bad]
        results[name] = {
            "launches": counts, "plain_calls": dict(plain.calls),
            "hist_first_last": (hist[0].item(), hist[-1].item()),
            "vs_f64": {"kernel": got, "textbook f32": text,
                       "bound": bound},
            "kernel vs plain per launch": sh.worst,
            "share of bound per launch": sh.share, "checks": checks}
        for m, c in counts.items():
            launches[m] = launches.get(m, 0) + c
            grid_launches[m] = grid_launches.get(m, 0) + c / pieces
        log(f"[general] {name} solve({iters}) at {list(shape)}: launches "
            f"{counts}; residual^2 {hist[0].item():.6g} -> "
            f"{hist[-1].item():.6g}; vs float64 (history, x): kernel "
            f"{got[0]:.3g} {got[1]:.3g}, textbook f32 {text[0]:.3g} "
            f"{text[1]:.3g}, bound {bound[0]:.3g} {bound[1]:.3g} (history "
            f"margin {bound[0] - got[0]:.3g}); per launch vs plain "
            f"{sh.share}; " + (f"checks FAILED: {bad}" if bad
                               else "checks hold"))
        del x
    return launches, grid_launches, results, solvers, failed


def general_attrs(torch, lib, T):
    """{(pass, route): attributes} of the general route's kernels: the
    cooperative ones' (registers, spill bytes, resident blocks per SM),
    K1's band march's with S2_gen and S2_4x at 4096 columns and K2's with
    S2_gen, S2_4x and S2_far (registers, spill bytes, blocks per SM,
    dynamic shared memory bytes; (pass, "general", stencil)), logged as
    ``[band]``."""
    import ctypes

    out = {}
    for which, m in enumerate(GEN_SSTEP):
        a = (ctypes.c_int * 3)()
        err = lib.ls_sstep_general_attrs(which, a)
        if err:
            raise RuntimeError(f"ls_sstep_general_attrs({which}): error "
                               f"{err}")
        out[m, "general_coop"] = tuple(a)
    for st in ("S2_gen", "S2_4x"):
        kw = gen_kw(st, N_GRID)
        a = (ctypes.c_int * 4)()
        err = lib.ls_step2_band_attrs(
            N_GRID, ctypes.byref(T._stencil_struct(kw["offsets"],
                                                   kw["values"])), a)
        if err:
            raise RuntimeError(f"ls_step2_band_attrs({st}): error {err}")
        out["step2", "general", st] = tuple(a)
        log(f"[band] K1 band march with {st} at {N_GRID} columns: {a[0]} "
            f"registers, {a[1]} B spilled, {a[3]} B of shared memory "
            f"(stride {T.band_stride(N_GRID, kw['offsets'])} floats), "
            f"{a[2]} blocks per SM; geometry "
            f"{T.band_geometry(N_GRID, N_GRID)} (strips, columns, rows, "
            "bands)")
    for st in ("S2_gen", "S2_4x", "S2_far"):
        kw = gen_kw(st, N_GRID)
        a = (ctypes.c_int * 4)()
        err = lib.ls_gram2_band_attrs(
            N_GRID, ctypes.byref(T._stencil_struct(kw["offsets"],
                                                   kw["values"])), a)
        if err:
            raise RuntimeError(f"ls_gram2_band_attrs({st}): error {err}")
        out["gram2", "general", st] = tuple(a)
        stride, clipped, _ = T.gram2_layout(N_GRID, kw["offsets"])
        log(f"[band] K2 band march with {st} at {N_GRID} columns: {a[0]} "
            f"registers, {a[1]} B spilled, {a[3]} B of shared memory "
            f"(stride {stride} floats, "
            f"{'clipped' if clipped else 'padded'}), {a[2]} blocks per SM")
    return out


def time_general(torch, T, device, bw, card, solvers):
    """Phase 5n.  Each GEN_ROWS kernel with its stencils on their grids
    (K1 on the band march with S2_gen and S2_4x, on the cooperative kernel
    with S2_far; K2 on the band march with S2_gen, S2_4x and S2_far, on
    the cooperative kernel with S2_past and, forced there at 4096^2, with
    S2_gen and S2_far): CUDA events over a ring of three input sets, CUDA
    graphs, and the plain versions; each GEN_TIMED_RUNS solve's ms/iter,
    host enqueue and idle share (a torch.profiler trace; a tenth of the
    solve on pieces, as 5j) on the s-step schedule and under
    LEGIONSOLVERS_NO_SSTEP (the two-pass schedule: K3 pq, then K4 and K3
    update on the band route).  Returns ({(pass, route, stencil): (ms,
    plain ms, graph ms)}, {run: {schedule: times}})."""
    out = {}
    for m, kind, st0, others in GEN_ROWS:
        for st in (st0, *others):
            shape = GEN_GRIDS.get(st, (N_GRID, N_GRID))
            n = shape[0] * shape[1]
            kw = gen_kw(st, shape[1])
            forced = gen_route(st, m) != kind
            if forced and not (m == "gram2" and kind == "general_coop"):
                raise AssertionError(f"{st} is off {m}'s {kind} route")
            # (the halo blocks are unused: kernel_call sizes step2's
            # outputs by them)
            ring = [flat_inputs(torch, T, shape, 90 + s, device, True, kw)
                    for s in range(3)]
            fns = {plain: [kernel_call(T, m, d, plain, kw) for d in ring]
                   for plain in (False, True)}
            k = iter(range(10**9))
            # K2's cooperative kernel off its route where forced
            with (forced_routes(T, ("gram2",), kind="general_coop")
                  if forced else contextlib.nullcontext()):
                ms = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
                g = graph_ms(torch, fns[False], 30)
            plain_ms = event_ms(torch, lambda: fns[True][next(k) % 3](), 6)
            sane(f"{m} {kind}", ms, KERNELS[m][2] * n, bw)
            out[m, kind, st] = (ms, plain_ms, g)
            log(f"[time] {kind} {m} with {st}: kernel {ms:.4f} ms (CUDA "
                f"graphs {g:.4f}), bound {KERNELS[m][2] * n / bw * 1e3:.4f}"
                f", plain {plain_ms:.4f} ms at {list(shape)} f32 on {card}")
            del ring, fns
    solves = {}
    for name in GEN_TIMED_RUNS:
        solver = solvers[name]
        st, pieces, spaces, _ = GEN_RUNS[name]
        n_tr = N_ITERS if pieces == 1 else N_ITERS // 10
        solves[name] = {}
        for sched, env in (("s-step", None),
                           ("two-pass", "LEGIONSOLVERS_NO_SSTEP")):
            with env_route(env, solver):
                ms, host = solve_ms(torch, solver, N_ITERS)
                label = "general_" + "".join(
                    c if c.isalnum() else "_" for c in f"{name} {sched}")
                dev = profile_solve(torch, solver, label, card,
                                    ms * n_tr / N_ITERS, n_iters=n_tr)
            r = {"ms/iter": ms / N_ITERS, "host ms/iter": host / N_ITERS,
                 "device ms/iter": dev / n_tr,
                 "idle": 1 - dev / n_tr / (ms / N_ITERS)}
            solves[name][sched] = r
            log(f"[time] general {name} {sched} solve({N_ITERS}) at 4096^2: "
                f"{r['ms/iter']:.4f} ms/iter (host enqueue "
                f"{r['host ms/iter']:.4f}, device {r['device ms/iter']:.4f} "
                f"over {n_tr} traced, idle {100 * r['idle']:.1f}%) on {card}")
    return out, solves


def general_rows(results, errs, times, bw, attrs):
    """The kernels line's rows of the general route (GEN_ROWS): launches
    from phase 4n's solves on the row's route (one piece, 4 pieces, the
    block; launches on pieces also in ``pieces_launches``), times from
    phase 5n on the row stencil's grid (the other stencils' beside them),
    registers and spill bytes (a band march's with S2_gen, and its shared
    memory and blocks per SM); no one PyTorch call computes an s-step
    pass."""
    rows = []
    for m, kind, st, others in GEN_ROWS:
        shape = GEN_GRIDS.get(st, (N_GRID, N_GRID))
        n = shape[0] * shape[1]
        launches = grid = on_pieces = 0
        for name, (rst, pieces, _, _) in GEN_RUNS.items():
            if gen_route(rst, m) != kind:
                continue
            c = results[name]["launches"].get(m, 0)
            launches += c
            grid += c / pieces
            on_pieces += c if pieces > 1 else 0
        wrapper, line, bpe = KERNELS[m]
        ms, plain_ms, g = times[m, kind, st]
        label = ("band march" if kind == "general"
                 else "general route, cooperative")
        row = kernel_row(f"{wrapper} [{m}] {label}", GEN_CSRC,
                         f"{PALLAS}:{line}", launches, errs[m, kind], ms,
                         plain_ms, bpe * n,
                         ops_per_elt(m, len(GEN_STENCILS[st])) * n, bw,
                         grid_launches=grid)
        row.update(graph_ms=g, kernel_route=kind, stencil=st,
                   pieces_launches=on_pieces, grid=list(shape))
        if kind == "general":
            regs, spill, per_sm, smem = attrs[m, kind, st]
            row.update(shared_memory_bytes=smem)
        else:
            regs, spill, per_sm = attrs[m, "general_coop"]
        row.update(registers=regs, spill_bytes=spill, blocks_per_sm=per_sm)
        for other in others:
            (row[f"{other}_ms"], row[f"{other}_plain_ms"],
             row[f"{other}_graph_ms"]) = times[m, kind, other]
        rows.append(row)
        log(f"[time] {kind} {m:5s} with {st} {ms:.4f} ms (graphs {g:.4f}), "
            f"bound {row['bound_ms']:.4f} ({row['pct_of_bound']:.1f}%), "
            f"{regs} registers, {spill} B spilled, {per_sm} blocks per SM, "
            f"launches {row['launches']} at {list(shape)}")
        if not launches:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "general route's path")
    return rows


# ---------------------------------------------------------------------------
# phase 4n, the band route: K3 (four modes) and K4 for the 2-D stencils off
# the strip and flat routes (csrc/band2d.cu); phase 5n: their times
# ---------------------------------------------------------------------------

BAND_CSRC = "legionsolvers_tpu_torch/csrc/band2d.cu"
# the band route's stencils at 4096^2: 4n's S2_gen (13 terms, |dx| to 100,
# a padded window) and S2_4x (7 terms), and 4l's wide_kw (9 terms, rows -8
# .. 1, (1, -4095): the window clipped to the row)
BAND_STENCILS = ("S2_gen", "S2_4x", "wide_kw")
# (R, C): a width under one strip and rows shorter than wide_kw's ring of
# 11 (3 rows); C = 128; C % 4 != 0 (130: scalar loads); a ragged last band
# (203 rows of 4096, bands of 16); two strips (5000 columns); a
# quarter-height piece of 4096^2 (64 bands)
BAND_EDGE_SHAPES = ((8, 128), (37, 1000), (3, 1000), (203, 4096), (33, 130),
                    (40, 5000), (1024, 4096))
# a stencil past the gate (a row span of 17: 18 ring rows of 16 KB at
# 4096 columns), which K3, K4 and K5a-c run on the tile kernels
BAND_PAST = ((64, 4096), "deep")
BAND_PASSES = tuple(ONE_PASS_NAMES)
K5_PASS = {"bicg_pv": "pv", "bicg_st": "st", "bicg_update": "update"}
TWO_PASS_200 = {"pq": 1, "update": N_ITERS, "xpay_pq": N_ITERS - 1}
BICG_200 = {m: N_ITERS for m in BICG_KERNELS}
# name -> (stencil, pieces, solver, solve length, launches, environment,
# compensated dots)
BAND_RUNS = {
    "S2_gen two-pass CG": ("S2_gen", 1, "cg", N_ITERS, TWO_PASS_200,
                           "LEGIONSOLVERS_NO_SSTEP", False),
    "S2_gen two-pass CG 4 pieces": (
        "S2_gen", GEN_PIECES, "cg", N_ITERS,
        {m: GEN_PIECES * c for m, c in TWO_PASS_200.items()},
        "LEGIONSOLVERS_NO_SSTEP", False),
    "S2_4x two-pass CG": ("S2_4x", 1, "cg", N_ITERS, TWO_PASS_200,
                          "LEGIONSOLVERS_NO_SSTEP", False),
    "S2_gen PCG": ("S2_gen", 1, "pcg", N_ITERS, {"y_dot": N_ITERS}, None,
                   False),
    "S2_gen GMRES(10)": ("S2_gen", 1, "gmres", GMRES_CYCLES,
                         {"y": 11 * GMRES_CYCLES + 1}, None, False),
    "S2_gen BiCGStab": ("S2_gen", 1, "bicg", N_ITERS, BICG_200, None, False),
    "S2_gen BiCGStab compensated": ("S2_gen", 1, "bicg", N_ITERS, BICG_200,
                                    None, True),
    "S2_4x BiCGStab": ("S2_4x", 1, "bicg", N_ITERS, BICG_200, None, False),
    "S2_gen BiCGStab 4 pieces": (
        "S2_gen", GEN_PIECES, "bicg", N_ITERS,
        {m: GEN_PIECES * c for m, c in BICG_200.items()}, None, False),
}
# the BiCGStab runs that phase 5n times (one piece, and a tenth of the
# solve traced on pieces)
BAND_TIMED_BICG = ("S2_gen BiCGStab", "S2_gen BiCGStab compensated",
                   "S2_4x BiCGStab", "S2_gen BiCGStab 4 pieces")
BAND_PCG_WINDOW = 1e-3  # 4m's: PCG held where textbook f32 PCG is within it


def band_kw(name, C):
    """The band route's stencil ``name`` at width C (BAND_STENCILS, and
    ``deep``: the cross with (-8, 100) and (8, -(C - 1)))."""
    if name == "wide_kw":
        return wide_kw(C)
    if name == "deep":
        return dict(offsets=OFFS + ((-8, 100 % C), (8, -(C - 1))),
                    values=VALS + (-0.25, -0.25))
    return terms_kw(GEN_STENCILS[name])


def k5_route(T, m, kw, C):
    """(route, source file) of K5 pass ``m`` (a BICG_KERNELS name) with the
    stencil ``kw`` on C columns: the band march's file where it takes the
    band route, the flat march's on the flat route (K5b on the 1-D view),
    the strip and tile kernels' otherwise."""
    kind = T.route(kw["offsets"], kw["values"], C, bicg=K5_PASS[m])[0]
    return kind, {"band": BAND_CSRC, "flat": FLAT_CSRC}.get(kind, BICG_CSRC)


def compare_band_k5(torch, T, TB, device):
    """Phase 4n, K5a-c on the band route: against their plain versions
    with BAND_STENCILS at 4096^2 and at BAND_EDGE_SHAPES, and BAND_PAST's
    stencil on the tile kernels,
    compensated dots off and on:
    phase 3b's bounds (elementwise 1e-5 * max|ref|, each dot 1e-4 of its
    Cauchy-Schwarz scale; compensated, each dot within 4e-7 of the float64
    sum of its f32 operands) and a repeat on the same inputs bit for bit.
    Returns {pass: max abs error} on the band route."""
    f64dot = lambda a, b: torch.dot(a.double().reshape(-1),
                                    b.double().reshape(-1)).item()
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    errs = dict.fromkeys(BICG_KERNELS, 0.0)
    cases = [((N_GRID, N_GRID), st) for st in BAND_STENCILS]
    cases += [(shape, st) for shape in BAND_EDGE_SHAPES
              for st in BAND_STENCILS if st != "S2_gen" or shape[1] > 100]
    cases += [BAND_PAST]
    for shape, st in cases:
        kw = band_kw(st, shape[1])
        d = bicg_inputs(torch, shape, 87, device)
        d["alpha"] = d["alpha"] * 1e-3  # K5c's x in place stays bounded
        for name in BICG_KERNELS:
            route = k5_route(T, name, kw, shape[1])[0]
            want = "tile" if st == BAND_PAST[1] else "band"
            if route != want:
                raise AssertionError(f"{name} with {st} at {shape} takes "
                                     f"the {route} route, not {want}")
            worst, worst_exact = 0.0, 0.0
            for comp in (False, True):
                got, again, ref = (run_bicg(TB, name, d, comp, plain, kw)
                                   for plain in (False, False, True))
                torch.cuda.synchronize()
                case = f"{name} with {st} at {list(shape)} compensated={comp}"
                if not all(same_bits(got[k], again[k]) for k in got):
                    raise AssertionError(f"{case}: a repeat is not "
                                         "bit-identical")
                ops = bicg_operands(T, name, d, ref, kw)
                for key, r in ref.items():
                    err = (got[key].double() - r.double()).abs().max().item()
                    if r.dim():
                        bound = 1e-5 * r.abs().max().item()
                    else:
                        a, b = ops[key]
                        bound = 1e-4 * nrm(a) * nrm(b)
                    if not err <= bound:
                        raise AssertionError(f"{case} {key}: kernel "
                                             "disagrees with its plain "
                                             f"version ({err:g} > {bound:g})")
                    worst = max(worst, err)
                if comp:
                    for key, (a, b) in bicg_operands(T, name, d, got,
                                                     kw).items():
                        exact = f64dot(a, b)
                        rel = abs(got[key].item() - exact) / abs(exact)
                        worst_exact = max(worst_exact, rel)
                        if rel > 4e-7:
                            raise AssertionError(f"{case} {key}: compensated "
                                                 f"dot {rel:g} off the "
                                                 "float64 sum")
            if st != BAND_PAST[1]:
                errs[name] = max(errs[name], worst)
            log(f"[band] {name} with {st} at {list(shape)} ({route} route) == "
                f"plain, f32 and compensated dots (max abs err {worst:.3g}; "
                f"compensated dots vs float64 sum max rel {worst_exact:.3g})"
                "; repeats bit for bit")
        del d
    return errs


def compare_band_kernels(torch, T, device):
    """Phase 4n, the band route's kernels: K3's four modes and K4 against
    their plain versions with BAND_STENCILS at 4096^2 (random halo blocks)
    and at BAND_EDGE_SHAPES (null and random halo blocks), each on the band
    route, and BAND_PAST's stencil on the tile kernels: phase 3's bounds
    (elementwise 1e-5 * max|ref|, each dot 1e-4 of its Cauchy-Schwarz
    scale) and a repeat on the same inputs bit for bit.  Returns {pass:
    max abs error} on the band route."""
    errs = dict.fromkeys(BAND_PASSES, 0.0)
    cases = [((N_GRID, N_GRID), st, True) for st in BAND_STENCILS]
    cases += [(shape, st, halos) for shape in BAND_EDGE_SHAPES
              for st in BAND_STENCILS for halos in (False, True)
              if st != "S2_gen" or shape[1] > 100]
    cases += [(BAND_PAST[0], BAND_PAST[1], True)]
    for shape, st, halos in cases:
        kw = band_kw(st, shape[1])
        route = T.route(kw["offsets"], kw["values"], shape[1])[0]
        want = "tile" if st == BAND_PAST[1] else "band"
        if route != want:
            raise AssertionError(f"{st} at {shape} takes the {route} route, "
                                 f"not {want}")
        d = one_pass_inputs(torch, shape, halos, device, seed=83)
        case = f"{st} at {list(shape)} halos={'random' if halos else 'null'}"
        worst = 0.0
        for mode in BAND_PASSES:
            k1, k2, ref = (run_mode(T, mode, d, plain, kw)
                           for plain in (False, False, True))
            torch.cuda.synchronize()
            if not all(torch.equal(k1[k], k2[k]) for k in k1):
                raise AssertionError(f"{mode} {case}: a repeat is not "
                                     "bit-identical")
            for key, r in ref.items():
                err = (k1[key].double() - r.double()).abs().max().item()
                bound = (one_pass_bound(torch, T, mode, d, ref, kw)
                         if key == "dot" else 1e-5 * r.abs().max().item())
                if not err <= bound:
                    raise AssertionError(f"{mode} {case} {key}: kernel "
                                         f"disagrees with its plain version "
                                         f"({err:g} > {bound:g})")
                if route == "band":
                    errs[mode] = max(errs[mode], err)
                worst = max(worst, err)
        log(f"[band] K3, K4 with {case} ({route} route) == plain (max abs "
            f"err {worst:.3g}); repeats bit for bit")
        del d
    return errs


def band_path(torch, np, T, TB, lt, device):
    """Phase 4n, the solves on the band route: ``entry.build_stencil_system
    (2, (4096, 4096), stencil=...)`` with S2_gen on one piece and on 4
    pieces of the card and with S2_4x on one piece, each CG solve(200) on
    the two-pass schedule (LEGIONSOLVERS_NO_SSTEP: K3 pq once, then K4 and
    K3 update), PCG and GMRES(10) with S2_gen, and the fused BiCGStab
    solve(200) with S2_gen (f32 and compensated dots; 4 pieces) and S2_4x
    (K5a-c on the band route): launches
    counted exactly (counts set to 0 just before each solve, read just
    after; each pass on its route per the operator's view), no plain
    version called, a repeat from the same state bit for bit; BiCGStab
    within FLAT_BICG_RTOL of float64 BiCGStab over the entries where
    textbook f32 BiCGStab stays within a tenth of it (4l's and 4m's rule),
    and ||b - Ax||^2 through ``planner.matvec`` after GAP_ITERS within
    BICG3_GAP of its history (4d's), on b = 1 + z where b = 1 leaves
    textbook f32 no window (:func:`bicg_accuracy`); the two-pass CG's
    history and
    x within twice textbook f32 CG's distance from float64 CG (floor
    GEN_F64_FLOOR, 4n's), PCG the same against textbook f32 PCG over the
    entries where it stays within BAND_PCG_WINDOW of float64 CG, GMRES(10)
    non-increasing within GMRES_SLACK; on 4 pieces also every launch held
    to its plain version (:class:`shadowed`), and the CG history and x
    within twice the larger of textbook f32 CG's distance from float64 CG
    and the distance of the same schedule on the same pieces driven by the
    plain versions (:func:`plain_driven`): the pieces' schedule sums each
    dot per piece, patched by f32 edge terms, in f32 (``_psum``), and on b
    = 1 its plain-driven run itself misses twice textbook f32's distance
    (ROADMAP queue 3, P9).  Returns (launches by pass, whole-grid launches
    by pass, results, {run: solver}, failed)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    f32c = lt.SolverOptions(entry_dtype=torch.float32, compensated_dots=True)
    shape = (N_GRID, N_GRID)
    refs = gen_refs(torch, device)
    h64g, x64g, _ = refs["S2_gen"]
    bicg_refs = {}
    c32, cx32 = textbook_pcg(torch, shape, N_ITERS, torch.float32, device,
                             terms_matvec(torch, S2_GEN), S2_GEN[0][1])
    wpcg = agree_window(c32, h64g, BAND_PCG_WINDOW)
    text_pcg = (rel_dev(c32[:wpcg], h64g[:wpcg]).max().item(),
                x_rel(cx32, x64g))
    del cx32
    launches, grid_launches, results, solvers, failed = {}, {}, {}, {}, []
    for name, (st, pieces, kind, iters, want, env, comp) in \
            BAND_RUNS.items():
        mesh = (make_mesh(pieces, devices=[device] * pieces) if pieces > 1
                else None)
        planner = build_stencil_system(2, shape, f32c if comp else f32,
                                       device, mesh=mesh,
                                       stencil=list(GEN_STENCILS[st]))
        op = planner.row_partitioned_matrices[0][0]
        v = op._view
        solver = flat_solver(lt, planner, kind)
        with env_route(env, solver), counted_calls(plain_names(T, TB),
                                                   solver) as plain:
            view_ok = (op.uses_pallas and v["kind"] == "2d"
                       and v["Br"] * pieces == N_GRID)
            if kind == "bicg":
                what = "K5a-c on the band route"
                view_ok = view_ok and op.supports_fused_bicgstab and all(
                    k5_route(T, m, dict(offsets=v["offs"], values=v["vals"]),
                             v["C"])[0] == "band" for m in BICG_KERNELS)
            else:
                what = "K3 and K4 on the band route"
                view_ok = view_ok and T.route(
                    v["offs"], v["vals"], v["C"])[0] == "band"
            hist, x, counts = counted_solve(torch, T, solver, iters)
            hist2, x2, _ = counted_solve(torch, T, solver, iters)
        solvers[name] = solver
        checks = {what: view_ok,
                  f"launches {want}": counts == want,
                  "no plain version called": not plain.calls,
                  "a repeat from the same state is bit-identical":
                      same_bits(hist, hist2) and same_bits(x, x2)}
        if kind != "bicg":  # f32 BiCGStab may break down: see below
            checks["finite history"] = bool(torch.isfinite(hist).all())
        del x2
        res = {"launches": counts, "plain_calls": dict(plain.calls),
               "hist_first_last": (hist[0].item(), hist[-1].item())}
        rule = f"(floor {GEN_F64_FLOOR})"
        ref_name = "textbook f32 CG's distance"
        if pieces > 1:
            with env_route(env, solver), shadowed(T, solver, TB=TB) as sh:
                restart(solver)
                solver.solve(iters)
                torch.cuda.synchronize()
            T.reset_launch_counts()
            res["kernel vs plain per launch"] = sh.worst
            res["share of bound per launch"] = sh.share
            checks["every launch within its plain version's bounds"] = (
                not sh.bad and sh.calls == want)
            if kind == "cg":
                h64, x64, _ = refs[st]
                with env_route(env, solver), plain_driven(T, solver,
                                                          cg_plain(T)):
                    hp, xp, _ = counted_solve(torch, T, solver, iters)
                res["plain-driven vs_f64"] = (rel_dev(hp, h64).max().item(),
                                              x_rel(xp, x64))
                ref_name = ("the larger of textbook f32 CG's and the "
                            "plain-driven schedule's distance")
                del xp
        if kind == "cg":
            h64, x64, text = refs[st]
            got = (rel_dev(hist, h64).max().item(), x_rel(x, x64))
            res["vs_f64"] = {"kernel": got, "textbook f32": text}
            ref = text
            if "plain-driven vs_f64" in res:
                ref = tuple(map(max, text, res["plain-driven vs_f64"]))
            checks[f"history and x within twice {ref_name} from float64 "
                   f"{rule}"] = (
                got[0] <= max(2 * ref[0], GEN_F64_FLOOR)
                and got[1] <= max(2 * ref[1], GEN_F64_FLOOR))
        elif kind == "bicg":
            acc = bicg_accuracy(torch, T, solver, st, hist, bicg_refs, device)
            res["accuracy"] = acc
            on = acc[-1]  # the right-hand side the checks read
            rhs = "" if len(acc) == 1 else f" on b = {on['b']}"
            checks[f"within {FLAT_BICG_RTOL} of float64 over the "
                   f"{on['window']} entries where textbook f32 is within a "
                   f"tenth of it{rhs}"] = (on["kernel vs_f64"]
                                          <= FLAT_BICG_RTOL
                                          and on["window"] >= 2)
            checks[f"||b - Ax||^2 vs history after {GAP_ITERS}, rel "
                   f"{BICG3_GAP}{rhs}"] = on["gap"] <= BICG3_GAP
        elif kind == "pcg":
            got = (rel_dev(hist[:wpcg], h64g[:wpcg]).max().item(),
                   x_rel(x, x64g))
            res["vs_f64"] = {"kernel": got, "textbook f32 pcg": text_pcg}
            res["window"] = wpcg
            checks[f"history (first {wpcg} entries) and x within twice "
                   f"textbook f32 PCG's distance from float64 CG {rule}"] = (
                got[0] <= max(2 * text_pcg[0], GEN_F64_FLOOR)
                and got[1] <= max(2 * text_pcg[1], GEN_F64_FLOOR)
                and wpcg >= 2)
        else:
            h = hist.double()
            rise = (h[1:] / h[:-1]).max().item()
            res["largest_rise"] = rise - 1
            checks[f"non-increasing within {GMRES_SLACK}"] = \
                rise <= 1 + GMRES_SLACK
        bad = [k for k, ok in checks.items() if not ok]
        failed += [f"band {name}: {k}" for k in bad]
        res["checks"] = checks
        results[name] = res
        for m, c in counts.items():
            launches[m] = launches.get(m, 0) + c
            grid_launches[m] = grid_launches.get(m, 0) + c / pieces
        log(f"[band] {name} solve({iters}) at 4096^2: launches {counts}; "
            f"residual^2 {hist[0].item():.6g} -> {hist[-1].item():.6g}; "
            + "".join(f"{k} {res[k]}; " for k in (
                "vs_f64", "plain-driven vs_f64", "window", "accuracy",
                "largest_rise", "share of bound per launch") if k in res)
            + (f"checks FAILED: {bad}" if bad else "checks hold"))
        del x
    return launches, grid_launches, results, solvers, failed


def bicg_accuracy(torch, T, solver, st, hist, refs, device):
    """Phase 4n's accuracy readings of a BiCGStab solve(N_ITERS) on b = 1
    (``hist``): the entries where textbook f32 BiCGStab stays within a
    tenth of FLAT_BICG_RTOL of float64 BiCGStab (the window), the
    kernel's largest distance from float64 over them, and
    :func:`bicg_gap`.  Where b = 1 leaves that window no entry past the
    first (S2_4x: A 1 = 0 inside the grid, and f32's rounding of its
    weights leaves float64 at the first iteration, so no f32 code can be
    held there), the same readings on b = 1 + z (z standard normal from
    the card's generator seeded with BLOCK_SEED) follow them, and the
    checks read those: with S2_4x textbook f32 stays within 1e-4 of
    float64 for 10 entries on b = 1 + z, 4 on b = 1 + 0.1 z and 2 (the
    second at 9.8e-5) on b = 1 + 0.01 z (torch's CPU draws at 4096^2).
    ``refs`` caches the textbook histories by (stencil, b).  Returns a
    list of {b, window, kernel vs_f64, textbook f32 vs_f64,
    gap, finite entries}, the one the checks read last."""
    shape = (N_GRID, N_GRID)
    planner = solver.planner
    A = terms_matvec(torch, GEN_STENCILS[st])
    out = []
    for label in ("1", "1 + z"):
        b = torch.ones(shape, device=device)
        if out:
            g = torch.Generator(device=device).manual_seed(BLOCK_SEED)
            b += torch.randn(shape, generator=g, device=device)
            planner.rhs_vectors[0].data.copy_(
                b.reshape(planner.rhs_vectors[0].data.shape))
            restart(solver)
            hist = solver.solve(N_ITERS)
        if (st, label) not in refs:
            h64, _ = textbook_bicgstab(torch, shape, N_ITERS, torch.float64,
                                       device, matvec=A, rhs=b)
            h32, _ = textbook_bicgstab(torch, shape, N_ITERS, torch.float32,
                                       device, matvec=A, rhs=b)
            refs[st, label] = (h64, h32, agree_window(h32, h64,
                                                      FLAT_BICG_RTOL / 10))
        h64, h32, win = refs[st, label]
        n = max(win, 1)  # entry 0 at least
        out.append({"b": label, "window": win,
                    "kernel vs_f64": rel_dev(hist[:n], h64[:n]).max().item(),
                    "textbook f32 vs_f64": rel_dev(h32[:n], h64[:n])
                    .max().item(),
                    "gap": bicg_gap(torch, T, solver),
                    "finite entries": finite_upto(hist),
                    "textbook f32 finite entries": finite_upto(h32)})
        if win >= 2:
            break
    planner.rhs_vectors[0].data.fill_(1.0)
    return out


def bicg_gap(torch, T, solver):
    """||b - Ax||^2 through ``planner.matvec`` after a BiCGStab
    solve(GAP_ITERS) from x0 = 0, against its last history entry
    (relative; phase 4d's check)."""
    planner = solver.planner
    restart(solver)
    h = solver.solve(GAP_ITERS)
    planner.matvec(solver.U, solver.SOL)
    torch.cuda.synchronize()
    T.reset_launch_counts()
    true_rr = torch.sum((planner.rhs_vectors[0].data - planner.get_vector(
        solver.U, 0).data).double() ** 2).item()
    return abs(true_rr - h[-1].item()) / h[-1].item()


class forced_routes:
    """Within the block, the passes named in ``passes`` (K5's "pv", "st",
    "update", K2's "gram2") take the route ``kind`` of ``module``'s
    ``route`` (the tile kernels by default) whatever the stencil, and the
    ``solvers``' cached runners are dropped on the way in and out."""

    def __init__(self, module, passes, *solvers, kind="tile"):
        self.module, self.passes, self.solvers = module, passes, solvers
        self.kind = kind

    def __enter__(self):
        self.route = route = self.module.route
        passes, kind = self.passes, self.kind

        def routed(offs, vals, C, sstep=False, bicg=None):
            if bicg in passes or sstep in passes:
                return kind, offs, vals, 0
            return route(offs, vals, C, sstep, bicg)

        self.module.route = routed
        drop_runners(*self.solvers)

    def __exit__(self, *exc):
        self.module.route = self.route
        drop_runners(*self.solvers)


BICG_GAP_DRAWS = 4  # --bicg-gap: b = 1 and three draws b = 1 + 0.01 z


def bicg_gap_draws(torch, lt, TB, device, card):
    """--bicg-gap [--tree DIR]: the fused BiCGStab's recurrence gap,
    |(||b - Ax||^2 in float64) - history| / history after GAP_ITERS
    iterations, f32 dots, with S2_4x and S2_gen at 4096^2 on b = 1 and b =
    1 + 0.01 z (z from the card's generator seeded 1, 2, 3), with K5a-c
    on their routes, K5a, K5b and K5c each on its tile kernel, K5a and K5b
    both on the tile, and driven by the plain versions: one log line per
    stencil and b."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    shape = (N_GRID, N_GRID)
    rows = []
    for st in ("S2_4x", "S2_gen"):
        A = terms_matvec(torch, GEN_STENCILS[st])
        planner = build_stencil_system(
            2, shape, lt.SolverOptions(entry_dtype=torch.float32), device,
            stencil=list(GEN_STENCILS[st]))
        solver = lt.BiCGStabSolver(planner)
        for seed in range(BICG_GAP_DRAWS):
            b = torch.ones(shape, device=device)
            if seed:
                g = torch.Generator(device=device).manual_seed(seed)
                b += 0.01 * torch.randn(shape, generator=g, device=device)
            planner.rhs_vectors[0].data.copy_(
                b.reshape(planner.rhs_vectors[0].data.shape))
            row = {"stencil": st, "b": f"1 + 0.01 z, seed {seed}" if seed
                   else "1"}
            for label, ctx in (
                    ("routes", forced_routes(TB, (), solver)),
                    ("K5a tile", forced_routes(TB, ("pv",), solver)),
                    ("K5b tile", forced_routes(TB, ("st",), solver)),
                    ("K5c tile", forced_routes(TB, ("update",), solver)),
                    ("both tile", forced_routes(TB, ("pv", "st"), solver)),
                    ("plain-driven", plain_driven(TB, solver,
                                                  bicg_plain(TB)))):
                with ctx:
                    restart(solver)
                    h = solver.solve(GAP_ITERS)
                    x = planner.sol_vectors[0].data.reshape(shape).double()
                    true_rr = torch.sum((b.double() - A(x)) ** 2).item()
                    row[label] = abs(true_rr - h[-1].item()) / h[-1].item()
            rows.append(row)
            log(f"[bicg-gap] {st}, b = {row['b']}, after {GAP_ITERS}: "
                + ", ".join(f"{k} {v:.3g}" for k, v in row.items()
                            if k not in ("stencil", "b")) + f" on {card}")
        del planner, solver
    log(json.dumps({"card": card, "bicg_gap": rows}))
    return 0


BAND_ACC_RHS = 6  # --band-accuracy: b = 1 and five draws b = 1 + 0.01 z


def band_accuracy(torch, lt, T, device, card):
    """--band-accuracy [--tree DIR]: the two-pass CG solve(200)
    (LEGIONSOLVERS_NO_SSTEP) on 4n's systems at 4096^2, S2_gen on one
    piece from BAND_ACC_RHS right-hand sides (b = 1, then b = 1 + 0.01 z,
    z drawn on the card from seeds 1, 2, ...) and on 4 pieces and S2_4x
    on one piece from b = 1, through the package this process imports
    (``--tree``: the tile kernels of a tree from before the band route),
    and the same schedule driven by the plain versions: each run's history
    and x distance from float64 CG beside textbook f32 CG's on the same
    b, one log line and one JSON line per run (ROADMAP queue 3, P9)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    shape = (N_GRID, N_GRID)
    rows = []
    for st, pieces, n_rhs in (("S2_gen", 1, BAND_ACC_RHS), ("S2_gen", 4, 1),
                              ("S2_4x", 1, 1)):
        A = terms_matvec(torch, GEN_STENCILS[st])
        mesh = (make_mesh(pieces, devices=[device] * pieces) if pieces > 1
                else None)
        planner = build_stencil_system(2, shape, f32, device, mesh=mesh,
                                       stencil=list(GEN_STENCILS[st]))
        solver = lt.CGSolver(planner)
        for k in range(n_rhs):
            b = torch.ones(shape, device=device)
            if k:
                g = torch.Generator(device=device).manual_seed(k)
                b += 0.01 * torch.randn(shape, generator=g, device=device)
            h64, x64 = classic_cg(torch, shape, N_ITERS, torch.float64,
                                  device, A, rhs=b)
            h32, x32 = classic_cg(torch, shape, N_ITERS, torch.float32,
                                  device, A, rhs=b)
            text = (rel_dev(h32, h64).max().item(), x_rel(x32, x64))
            planner.rhs_vectors[0].data.copy_(
                b.reshape(planner.rhs_vectors[0].data.shape))
            for route in ("kernels", "plain-driven"):
                ctx = (plain_driven(T, solver, cg_plain(T))
                       if route != "kernels" else env_route(None, solver))
                with env_route("LEGIONSOLVERS_NO_SSTEP", solver), ctx:
                    hist, x, counts = counted_solve(torch, T, solver,
                                                    N_ITERS)
                got = (rel_dev(hist, h64).max().item(), x_rel(x, x64))
                row = {"stencil": st, "pieces": pieces,
                       "rhs": "1" if not k else f"1 + 0.01 z, seed {k}",
                       "route": route, "launches": counts, "vs_f64": got,
                       "textbook f32 vs_f64": text,
                       "within twice textbook (floor 1e-4)": all(
                           a <= max(2 * t, GEN_F64_FLOOR)
                           for a, t in zip(got, text))}
                rows.append(row)
                log(f"[band-accuracy] {st} on {pieces} piece(s), b = "
                    f"{row['rhs']}, {route}: history {got[0]:.4g}, x "
                    f"{got[1]:.4g} off float64 CG (textbook f32 {text[0]:.4g}"
                    f", {text[1]:.4g}); launches {counts} on {card}")
                log(json.dumps(row))
                del x
            del h64, x64, h32, x32
    return rows


def band_attrs(lib, T):
    """{(pass, stencil): (registers, spill bytes, resident blocks per SM,
    dynamic shared memory bytes)} of the band route's kernels (their
    16-byte variant, each stencil's window) with BAND_STENCILS at 4096
    columns, from ``ls_pass_band_attrs`` (cudaFuncGetAttributes and the
    occupancy calculator), logged as ``[band2d]``; {} for a tree without
    the band route (``--tree`` of an older tree)."""
    import ctypes

    if not hasattr(lib, "ls_pass_band_attrs"):
        return {}
    out = {}
    # ls_pass_band_attrs numbers K3's modes and K4 0..4, K5a 5, K5b 6, K5c
    # 7 (a tree from before K5 on the band route refuses 5..7)
    passes = list(enumerate(BAND_PASSES)) + list(enumerate(BICG_KERNELS, 5))
    for st in BAND_STENCILS:
        kw = band_kw(st, N_GRID)
        s = T._stencil_struct(kw["offsets"], kw["values"])
        for which, m in passes:
            a = (ctypes.c_int * 4)()
            err = lib.ls_pass_band_attrs(which, N_GRID, ctypes.byref(s), a)
            if err and which < 5:
                raise RuntimeError(f"ls_pass_band_attrs({which}, {st}): "
                                   f"error {err}")
            if not err:
                out[m, st] = tuple(a)
        lay = T.pass_layout(N_GRID, kw["offsets"])
        log(f"[band2d] with {st} at {N_GRID} columns (ring row {lay[0]} "
            f"floats, {'clipped' if lay[1] else 'padded'}, {lay[2]} rows): "
            + "; ".join(f"{m} {out[m, st][0]} registers, {out[m, st][1]} B "
                        f"spilled, {out[m, st][2]} blocks per SM, "
                        f"{out[m, st][3]} B shared" for _, m in passes
                        if (m, st) in out))
    return out


def library_band(torch, T, device, card):
    """F.conv2d computing K3's y on the band route at 4096^2 over S2_4x's
    3 x 5 box and S2_gen's 3 x 201 box (:func:`conv2d_y`): {stencil: ms}.
    wide_kw has none: its box is 10 rows by 4196 columns (dx from -4095 to
    100), 41,960 weights of which 9 are not zero."""
    return {st: conv2d_y(torch, T, device, card, GEN_STENCILS[st], 63,
                         f"with {st} (band route)")
            for st in ("S2_4x", "S2_gen")}


def time_band(torch, T, device, bw, card):
    """Phase 5n, the band route: K3's four modes and K4 at 4096^2 with
    BAND_STENCILS (no halo blocks, as the one-piece solves call them):
    CUDA events over a ring of three input sets, CUDA graphs, and the
    plain versions.  Returns {(pass, stencil): (ms, plain ms, graph ms)}."""
    n = N_GRID * N_GRID
    out = {}
    for st in BAND_STENCILS:
        kw = band_kw(st, N_GRID)
        ring = [make_inputs(torch, T, (N_GRID, N_GRID), 94 + s, device)
                for s in range(3)]
        for m in BAND_PASSES:
            fns = {plain: [kernel_call(T, m, d, plain, kw) for d in ring]
                   for plain in (False, True)}
            k = iter(range(10**9))
            ms = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
            plain_ms = event_ms(torch, lambda: fns[True][next(k) % 3](), 6)
            g = graph_ms(torch, fns[False], 30)
            sane(f"{m} band {st}", ms, KERNELS[m][2] * n, bw)
            out[m, st] = (ms, plain_ms, g)
            log(f"[time] band {m:8s} with {st}: kernel {ms:.4f} ms (CUDA "
                f"graphs {g:.4f}), bound {KERNELS[m][2] * n / bw * 1e3:.4f}"
                f", plain {plain_ms:.4f} ms at 4096^2 f32 on {card}")
            del fns
        del ring
    return out


def time_band_k5(torch, T, TB, device, bw, card):
    """Phase 5n, K5 at 4096^2: K5a-c on the band route with BAND_STENCILS,
    their tile kernels on the same inputs (the route before this band
    march took them); f32 dots, CUDA events over a ring of three input
    sets, CUDA graphs, and the plain versions.  Returns {(pass, stencil):
    (ms, plain ms, graph ms, tile ms, tile graph ms)}."""
    n = N_GRID * N_GRID
    out = {}
    ring = [bicg_inputs(torch, (N_GRID, N_GRID), 96 + s, device)
            for s in range(3)]
    for d in ring:
        d["alpha"] = d["alpha"] * 1e-3  # keep update's in-place x bounded
        d["p_out"], d["v_out"], d["r_out"] = (torch.empty_like(d["r"])
                                              for _ in range(3))
    cases = [(m, st) for st in BAND_STENCILS for m in BICG_KERNELS]
    for m, st in cases:
        kw = band_kw(st, N_GRID)
        route = k5_route(T, m, kw, N_GRID)[0]
        if route != "band":
            raise AssertionError(f"{m} with {st} takes the {route} route")
        outs = lambda d: ((d["p_out"], d["v_out"]) if m == "bicg_pv"
                          else d["r_out"])
        fns = {plain: [bicg_call(TB, m, d, False, plain, outs(d), kw)
                       for d in ring] for plain in (False, True)}
        k = iter(range(10**9))
        ms = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
        plain_ms = event_ms(torch, lambda: fns[True][next(k) % 3](), 6)
        g = graph_ms(torch, fns[False], 30)
        bpe = BICG_KERNELS[m][1]
        sane(f"{m} {route} {st}", ms, bpe * n, bw)
        with forced_routes(TB, (K5_PASS[m],)):
            tile = event_ms(torch, lambda: fns[False][next(k) % 3](), 30)
            tile_g = graph_ms(torch, fns[False], 30)
        out[m, st] = (ms, plain_ms, g, tile, tile_g)
        log(f"[time] {route} {m:11s} with {st}: kernel {ms:.4f} ms (CUDA "
            f"graphs {g:.4f}), bound {bpe * n / bw * 1e3:.4f}, plain "
            f"{plain_ms:.4f} ms; tile kernel {tile:.4f} ms (graphs "
            f"{tile_g:.4f}) at 4096^2 f32 on {card}")
        del fns
    del ring
    return out


def time_band_solves(torch, TB, solvers, bw, card):
    """Phase 5n, the BiCGStab solves on the band route (BAND_TIMED_BICG):
    ms/iter, host enqueue and idle share (a torch.profiler trace; a tenth
    of the solve on pieces, as 5j), and the S2_gen one-piece solve again
    with K5c on its tile kernel (:class:`forced_routes`).
    Returns {run: {route: times}}."""
    n = N_GRID * N_GRID
    nbytes = (60 * N_ITERS + 16) * n
    out = {}
    runs = [(name, "band") for name in BAND_TIMED_BICG]
    runs.append(("S2_gen BiCGStab", "tile"))
    for name, route in runs:
        solver = solvers[name]
        pieces = BAND_RUNS[name][1]
        n_tr = N_ITERS if pieces == 1 else N_ITERS // 10
        ctx = forced_routes(TB, ("update",) if route == "tile" else (),
                            solver)
        with ctx:
            ms, host = solve_ms(torch, solver, N_ITERS)
            label = "band_" + "".join(c if c.isalnum() else "_"
                                      for c in f"{name} {route}")
            dev = profile_solve(torch, solver, label, card,
                                ms * n_tr / N_ITERS, n_iters=n_tr)
        sane(f"{name} ({route})", ms, nbytes, bw)
        r = {"ms/iter": ms / N_ITERS, "host ms/iter": host / N_ITERS,
             "device ms/iter": dev / n_tr,
             "idle": 1 - dev / n_tr / (ms / N_ITERS)}
        out.setdefault(name, {})[route] = r
        log(f"[time] band {name} solve({N_ITERS}), K5c on the {route} "
            f"kernel, at 4096^2: {r['ms/iter']:.4f} ms/iter (host "
            f"enqueue {r['host ms/iter']:.4f}, device "
            f"{r['device ms/iter']:.4f} over {n_tr} traced, idle "
            f"{100 * r['idle']:.1f}%) on {card}")
    return out


def band_k5_rows(T, results, errs, times, bw, attrs):
    """The kernels line's rows of K5 on phase 4n's BiCGStab runs: K5a-c on
    the band route (times with S2_gen, the stencil of most runs; S2_4x's
    and wide_kw's beside them, and each one's tile kernel's); launches
    from the runs (one piece, 4 pieces), registers, spill bytes, blocks
    per SM and shared memory of the band kernels with S2_gen.  No one
    PyTorch call computes a K5 pass."""
    n = N_GRID * N_GRID
    rows = []
    for m in BICG_KERNELS:
        launches = grid = on_pieces = 0
        for name, (st, pieces, *_) in BAND_RUNS.items():
            c = results[name]["launches"].get(m, 0)
            launches += c
            grid += c / pieces
            on_pieces += c if pieces > 1 else 0
        line, bpe = BICG_KERNELS[m]
        route, source = k5_route(T, m, band_kw("S2_gen", N_GRID), N_GRID)
        ms, plain_ms, g, tile, tile_g = times[m, "S2_gen"]
        row = kernel_row(f"{m} {route} route", source,
                         f"{BICG_PALLAS}:{line}", launches, errs.get(m, 0.0),
                         ms, plain_ms, bpe * n,
                         ops_per_elt(m, len(S2_GEN)) * n, bw,
                         grid_launches=grid)
        row.update(graph_ms=g, kernel_route=route, stencil="S2_gen",
                   pieces_launches=on_pieces, tile_ms=tile,
                   tile_graph_ms=tile_g)
        if (m, "S2_gen") in attrs:
            regs, spill, per_sm, smem = attrs[m, "S2_gen"]
            row.update(registers=regs, spill_bytes=spill,
                       blocks_per_sm=per_sm, shared_memory_bytes=smem)
        for other in ("S2_4x", "wide_kw"):
            o_ms, o_plain, o_g, o_tile, o_tile_g = times[m, other]
            row.update({f"{other}_ms": o_ms, f"{other}_plain_ms": o_plain,
                        f"{other}_graph_ms": o_g, f"{other}_tile_ms": o_tile,
                        f"{other}_tile_graph_ms": o_tile_g})
            if (m, other) in attrs:
                row[f"{other}_attrs"] = attrs[m, other]
        rows.append(row)
        log(f"[time] {route} {m:11s} with S2_gen {ms:.4f} ms (graphs "
            f"{g:.4f}), bound {row['bound_ms']:.4f} "
            f"({row['pct_of_bound']:.1f}%), launches {launches}, "
            f"{row['ms_lost']:.2f} ms lost at 4096^2; tile kernel "
            f"{tile:.4f} ms (graphs {tile_g:.4f})")
        if not launches:
            raise AssertionError(f"{row['name']} never launched on phase "
                                 "4n's BiCGStab runs")
    return rows


def band_rows(results, errs, times, bw, attrs, conv):
    """The kernels line's rows of the band route, one per K3 mode and K4:
    launches from phase 4n's band runs (one piece, 4 pieces; launches on
    pieces also in ``pieces_launches``), times from phase 5n at 4096^2 with
    S2_gen (the stencil of most runs; S2_4x's and wide_kw's beside them),
    registers, spill bytes, blocks per SM and shared memory with S2_gen,
    and K3 y's library time (F.conv2d over S2_gen's box; S2_4x's beside
    it)."""
    n = N_GRID * N_GRID
    rows = []
    for m in BAND_PASSES:
        launches = grid = on_pieces = 0
        for name, (st, pieces, *_) in BAND_RUNS.items():
            c = results[name]["launches"].get(m, 0)
            launches += c
            grid += c / pieces
            on_pieces += c if pieces > 1 else 0
        wrapper, line, bpe = KERNELS[m]
        ms, plain_ms, g = times[m, "S2_gen"]
        row = kernel_row(f"{wrapper} [{m}] band route", BAND_CSRC,
                         f"{PALLAS}:{line}", launches, errs[m], ms, plain_ms,
                         bpe * n, ops_per_elt(m, len(S2_GEN)) * n, bw,
                         conv["S2_gen"] if m == "y" else None,
                         grid_launches=grid)
        row.update(graph_ms=g, kernel_route="band", stencil="S2_gen",
                   pieces_launches=on_pieces)
        if attrs:
            regs, spill, per_sm, smem = attrs[m, "S2_gen"]
            row.update(registers=regs, spill_bytes=spill,
                       blocks_per_sm=per_sm, shared_memory_bytes=smem)
        for other in ("S2_4x", "wide_kw"):
            o_ms, o_plain, o_g = times[m, other]
            row.update({f"{other}_ms": o_ms, f"{other}_plain_ms": o_plain,
                        f"{other}_graph_ms": o_g})
            if attrs:
                row[f"{other}_attrs"] = attrs[m, other]
        if m == "y":
            row["S2_4x_library_ms"] = conv["S2_4x"]
        rows.append(row)
        log(f"[time] band {m:8s} with S2_gen {ms:.4f} ms (graphs {g:.4f}), "
            f"bound {row['bound_ms']:.4f} ({row['pct_of_bound']:.1f}%), "
            f"launches {launches}, {row['ms_lost']:.2f} ms lost at 4096^2")
        if not launches:
            raise AssertionError(f"{row['name']} never launched on the band "
                                 "route's path")
    return rows


# -- phase 4o ------------------------------------------------------------------

# 4o's sizes, cut to fit what the library saves in 4e-g and 4k (~30 s on
# an H100's host): at 4096^2 for the ELL and DIA checks and 2048^2 for RCM
# 4o took 49 s of a full run
UTILS_GRID = 2048      # 4o(a): the 5-point Laplacian's fill, its 4 pieces'
                       # halo columns and ELL slabs, its DIA offsets and
                       # coefficients, each held to its numpy version
UTILS_MM = 1024        # 4o(a) RCM and 4o(b): the scrambled Laplacian
UTILS_ITERS = 100      # 4o(c): solve(100), checkpoint, solve(100)
UTILS_DIR = pathlib.Path("build") / "utils_4o"  # the files 4o writes


def unloaded(TN, fn, *args):
    """(``fn(*args)`` with the host library's numpy versions, and its host
    seconds)."""
    with TN.numpy_versions():
        return timed(fn, *args)


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def same_arrays(np, a, b):
    """Bit for bit, through tuples; None only equals None."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple)
                and len(a) == len(b)
                and all(same_arrays(np, x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def bandwidth(np, rows, cols, perm):
    iperm = np.empty(len(perm), np.int64)
    iperm[perm] = np.arange(len(perm))
    return int(np.abs(iperm[rows] - iperm[cols]).max())


def scrambled_laplacian(np, lt, nx, options):
    """The 5-point Laplacian on nx^2 with rows and columns scrambled by
    ``default_rng(0).permutation`` (phase 4f's system at another size)."""
    a = lt.create_coo_stencil_matrix((nx, nx), lt.laplacian_stencil(2))
    n = a.n_range
    pr = np.random.default_rng(0).permutation(n)
    return lt.COOMatrix(pr[a.rows], pr[a.cols], a.vals, n, n, name="scr",
                        options=options)


def host_library(np, lt, scr, card):
    """4o(a): the library loaded on the card's host, and each entry point
    held to its numpy version bit for bit, with both host times: the
    UTILS_GRID^2 5-point fill, then on that Laplacian the halo columns and
    ELL packing of its PIECES pieces and its DIA offsets and f32 and f64
    coefficients; RCM on the scrambled UTILS_MM^2 system (``scr``, 4o(b)'s)
    against scipy's, its bandwidth no larger.  Returns (results,
    failed)."""
    from legionsolvers_tpu_torch.native import bindings as TN
    from legionsolvers_tpu_torch.parallel.dia_op import MAX_DIAGONALS
    from legionsolvers_tpu_torch.problems.stencil import stencil_coo_arrays

    res, failed = {}, []
    loaded = TN.available()  # built and loaded at its first use
    log(f"[utils] host library: loaded {loaded} ({TN.BUILD_INFO})")
    if not loaded:
        return {"loaded": False, "error": TN.BUILD_INFO.get("error")}, [
            "4o: the host library does not load"]
    res["loaded"], res["build_s"] = True, TN.BUILD_INFO["seconds"]

    def hold(name, fn, *args):
        got, lib_s = timed(fn, *args)
        want, np_s = unloaded(TN, fn, *args)
        same = same_arrays(np, got, want)
        res[name] = {"library_s": lib_s, "numpy_s": np_s, "bit_for_bit": same}
        log(f"[utils] {name}: library {lib_s:.3f} s, numpy {np_s:.3f} s on "
            f"the host; bit for bit {same}")
        if not same:
            failed.append(f"4o: {name} differs from its numpy version")
        return got

    g = f"{UTILS_GRID}^2"
    rows, cols, vals, n = hold(f"5-point fill {g}", stencil_coo_arrays,
                               (UTILS_GRID, UTILS_GRID),
                               lt.laplacian_stencil(2))
    B = -(-n // PIECES)
    starts = np.searchsorted(rows, np.arange(PIECES + 1) * B)
    pieces = [(rows[a:b] - s * B, cols[a:b], vals[a:b], s * B)
              for s, (a, b) in enumerate(zip(starts[:-1], starts[1:]))]
    halos = lambda: tuple(TN.shard_halo_columns(c, d0, B)
                          for _, c, _, d0 in pieces)
    halo = hold(f"halo columns, {PIECES} pieces of {g}", halos)
    L = max(int(np.bincount(r).max()) for r, _, _, _ in pieces)
    packs = lambda: tuple(
        TN.pack_ell_shard(r, c, v, B, B, d0, h, L, B + len(h))
        for (r, c, v, d0), h in zip(pieces, halo))
    hold(f"ELL packing, {PIECES} pieces of {g}", packs)
    del pieces

    uoffs = hold(f"DIA offsets {g}", TN.dia_unique_offsets, rows, cols,
                 MAX_DIAGONALS)
    for dt in (np.float32, np.float64):
        hold(f"DIA coefficients {g} {np.dtype(dt).name}", TN.dia_accumulate,
             rows, cols, vals, uoffs, n, dt)

    rows, cols, n = scr.rows, scr.cols, scr.n_range
    perm, lib_s = timed(TN.rcm_permutation, n, rows, cols)
    ref, sp_s = unloaded(TN, TN.rcm_permutation, n, rows, cols)
    bw, bw_sp = (bandwidth(np, rows, cols, p) for p in (perm, ref))
    is_perm = bool((np.sort(perm) == np.arange(n)).all())
    same = same_arrays(np, perm, ref)
    res[f"RCM scrambled {UTILS_MM}^2"] = {
        "library_s": lib_s, "scipy_s": sp_s, "bandwidth": bw,
        "bandwidth_scipy": bw_sp, "same_as_scipy": same}
    log(f"[utils] RCM scrambled {UTILS_MM}^2: library {lib_s:.3f} s "
        f"(bandwidth {bw}), scipy {sp_s:.3f} s (bandwidth {bw_sp}) on the "
        f"host; the same permutation: {same}")
    if not is_perm or bw > bw_sp:
        failed.append("4o: RCM is not a permutation no wider than scipy's")
    log(f"[utils] host seconds on {card}")
    return res, failed


def matrix_market_path(torch, np, lt, T, device, A):
    """4o(b): the scrambled UTILS_MM^2 5-point Laplacian ``A`` (f32)
    written to a Matrix Market file and read back (the arrays exactly the
    in-memory matrix's), then built by ``entry.build_explicit_system`` on
    the card from the file and from memory and solved by CG solve(N_ITERS)
    with b = 1, x0 = 0: the two histories and x bit for bit, the kernel
    (K8 or K9, where the planner's RCM upgrade sends it) launched once per
    iteration and nothing else.  Returns (results, failed)."""
    from legionsolvers_tpu_torch.utils import io as TIO

    f32 = A.options
    n = A.n_range
    path = UTILS_DIR / f"scrambled_{UTILS_MM}.mtx"
    _, write_s = timed(TIO.write_matrix_market, str(path), A)
    size = path.stat().st_size
    B, read_s = timed(TIO.read_matrix_market, str(path), f32)
    path.unlink()
    same = (same_arrays(np, A.rows, B.rows) and same_arrays(np, A.cols, B.cols)
            and same_arrays(np, np.asarray(A.vals, np.float64), B.vals)
            and (B.n_range, B.n_domain) == (n, n))
    runs = {}
    for label, M in (("file", B), ("memory", A)):
        planner, build_s = timed(lt.build_explicit_system, M, f32, device)
        solver = lt.CGSolver(planner)
        torch.cuda.synchronize()
        T.reset_launch_counts()
        hist = solver.solve(N_ITERS)
        torch.cuda.synchronize()
        runs[label] = (hist, planner.sol_vectors[0].data.clone(),
                       dict(T.LAUNCHES), build_s,
                       chain(planner.row_partitioned_matrices[0][0]))
    T.reset_launch_counts()
    (hf, xf, cf, bf, chf), (hm, xm, cm, bm, chm) = runs["file"], runs["memory"]
    kernel = {"DiaOperator": "dia2d_dot", "WinEllOperator": "winell"}.get(
        chf[-1])
    checks = {
        "the file reads back to the in-memory arrays exactly": same,
        "both builds pick one chain": chf == chm,
        "the chain ends on K8 or K9": kernel is not None,
        f"the kernel launched {N_ITERS} times, nothing else":
            cf == cm == {kernel: N_ITERS},
        "history bit for bit": same_bits(hf, hm),
        "x bit for bit": same_bits(xf, xm),
        "finite history": bool(torch.isfinite(hf).all()),
    }
    log(f"[utils] Matrix Market: {n} rows, {A.n_kernel} entries, "
        f"{size / 1e6:.1f} MB; write {write_s:.3f} s, read {read_s:.3f} s on "
        f"the host; builds from the file {bf:.2f} s, from memory {bm:.2f} s; "
        f"{chf}; launches {cf}; residual^2 {hf[0].item():.6g} -> "
        f"{hf[-1].item():.6g}; checks {checks}")
    res = {"n": n, "nnz": A.n_kernel, "bytes": size, "write_s": write_s,
           "read_s": read_s, "build_s": {"file": bf, "memory": bm},
           "chain": chf, "launches": cf, "checks": checks}
    return res, [f"4o Matrix Market: {k}" for k, ok in checks.items()
                 if not ok]


def checkpoint_path(torch, lt, T, device):
    """4o(c): the main path (2-D 5-point CG, N_GRID^2, f32) on one piece
    and on PIECES pieces: ``s1.solve(UTILS_ITERS)``, ``save_checkpoint``,
    ``load_checkpoint`` into a fresh ``s2``; ``s2.solve(UTILS_ITERS)``
    equals ``s1.solve(UTILS_ITERS)`` continued, bit for bit, in the
    history and x.  Returns (results, failed)."""
    from legionsolvers_tpu_torch.entry import build_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh
    from legionsolvers_tpu_torch.utils import io as TIO

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    res, failed = {}, []
    for pieces in (1, PIECES):
        mesh = (make_mesh(pieces, devices=[device] * pieces) if pieces > 1
                else None)
        make = lambda: lt.CGSolver(build_system(N_GRID, f32, device,
                                                mesh=mesh))
        s1 = make()
        s1.solve(UTILS_ITERS)
        path = UTILS_DIR / f"checkpoint_{pieces}.npz"
        torch.cuda.synchronize()
        _, save_s = timed(TIO.save_checkpoint, str(path), s1)
        s2 = make()
        _, load_s = timed(TIO.load_checkpoint, str(path), s2)
        size = path.stat().st_size
        path.unlink()
        torch.cuda.synchronize()
        h1 = s1.solve(UTILS_ITERS)
        x1 = s1.planner.sol_vectors[0].data.clone()
        T.reset_launch_counts()
        h2 = s2.solve(UTILS_ITERS)
        torch.cuda.synchronize()
        launches = dict(T.LAUNCHES)
        T.reset_launch_counts()
        checks = {"history bit for bit": same_bits(h1, h2),
                  "x bit for bit": same_bits(
                      x1, s2.planner.sol_vectors[0].data),
                  "kernels launched": sum(launches.values()) > 0}
        label = f"{pieces} piece{'s' if pieces > 1 else ''}"
        log(f"[utils] checkpoint {N_GRID}^2 on {label}: {size / 1e6:.1f} MB, "
            f"save {save_s:.3f} s, load {load_s:.3f} s on the host; resumed "
            f"solve({UTILS_ITERS}) launches {launches}; residual^2 "
            f"{h2[0].item():.6g} -> {h2[-1].item():.6g}; checks {checks}")
        res[label] = {"bytes": size, "save_s": save_s, "load_s": load_s,
                      "launches": launches, "checks": checks}
        failed += [f"4o checkpoint {label}: {k}" for k, ok in checks.items()
                   if not ok]
        del s1, s2, x1
    return res, failed


def utils_path(torch, np, lt, T, device, card):
    """Phase 4o: the host library (a), Matrix Market to the card (b) and
    checkpoints on the card (c).  Returns (results, failed)."""
    t0 = time.perf_counter()
    seconds = {}
    UTILS_DIR.mkdir(parents=True, exist_ok=True)
    scr = scrambled_laplacian(np, lt, UTILS_MM,
                              lt.SolverOptions(entry_dtype=torch.float32))
    results, failed = {}, []
    results["library"], f = host_library(np, lt, scr, card)
    failed += f
    seconds["a"] = time.perf_counter() - t0
    results["matrix_market"], f = matrix_market_path(torch, np, lt, T, device,
                                                     scr)
    failed += f
    del scr
    seconds["b"] = time.perf_counter() - t0 - seconds["a"]
    results["checkpoint"], f = checkpoint_path(torch, lt, T, device)
    failed += f
    seconds["c"] = time.perf_counter() - t0 - seconds["a"] - seconds["b"]
    results["seconds"] = seconds
    log(f"[utils] 4o's parts, s: {seconds}")
    return results, failed


# ---------------------------------------------------------------------------
# phase 4p: a mesh over two processes sharing the card
# ---------------------------------------------------------------------------

PROC_RANKS = 2                # workers, PIECES // PROC_RANKS pieces each
PROC_DIA = N_GRID // 2        # 4p(b), (c): the explicit 5-point Laplacian
PROC_TIMEOUT_S = 300          # each worker's limit
PROC_REPS = 200               # exchanges timed per helper
PROC_TIMED = N_ITERS // 8     # iterations of each timed solve
PROC_ITERS_E_G = N_ITERS // 2  # (e), (f) and PCG's counted solves
PROC_DIR = pathlib.Path("build") / "processes_4p"  # the workers' results
PROC_LAUNCHES = {"s-step": ("step2", "gram2"),
                 "two-pass": ("pq", "update", "xpay_pq"),
                 "DIA": ("dia2d_dot",), "ELL": ("winell",),
                 "BiCGStab": tuple(BICG_KERNELS),
                 "block CG": ("step2", "gram2"),
                 "block BiCGStab": tuple(BICG_KERNELS),
                 "GMRES(10)": ("y",), "PCG(Jacobi)": ("dia2d_dot",),
                 "3-D CG": ("pq3d", "update3d", "xpay_pq3d"),
                 "3-D BiCGStab step()": ("y3d", "y_dot3d"),
                 "1-D CG": ("pq", "update", "xpay_pq"),
                 "1-D BiCGStab": tuple(BICG_KERNELS),
                 "RCM": ("winell",)}
# the part of 4p each run belongs to
PROC_PART = {"s-step": "a", "two-pass": "a", "DIA": "b", "ELL": "c",
             "BiCGStab": "e", "block CG": "f", "block BiCGStab": "f",
             "GMRES(10)": "g", "PCG(Jacobi)": "g", "3-D CG": "i",
             "3-D BiCGStab step()": "i", "1-D CG": "j",
             "1-D BiCGStab": "j", "RCM": "k"}
PROC_BITS = ("s-step", "two-pass", "BiCGStab", "block CG", "block BiCGStab",
             "3-D CG", "1-D CG", "1-D BiCGStab")
# (k): the scrambled PROC_DIA^2 Laplacian of phase 4f through the
# planner's RCM upgrade, the chain phase 4k's planner picks on 4 pieces
PROC_RCM_CHAIN = XP_CHAIN["scrambled 2048^2"]
# (h): dryrun_multichip's sections on the fused runners, bit for bit one
# process's; the eager ones' dots sum per piece across processes and over
# the whole vector on one process: within PROC_DRYRUN_RTOL
PROC_DRYRUN_BITS = ("fused", "sstep", "bicgstab", "block-cg", "block-bicg")
PROC_DRYRUN_RTOL = 1e-4  # tests/test_torch_multiprocess.py's JAX_RTOL
PROC_ENTRY_RTOL = 1e-5   # entry()'s step on the card vs on the CPU


def proc_runs(torch, np, lt, T, device, mesh):
    """The solves of phase 4p on ``mesh`` (4 pieces, on one process or
    this process's of a mesh over processes): (a) 2-D CG at N_GRID^2,
    s-step and two-pass; (b) the explicit PROC_DIA^2 Laplacian on the
    DiaOperator, (c) on the sharded ELL, each with one matvec of a seeded
    x; (e) the fused 2-D BiCGStab at N_GRID^2; (f) block CG and block
    BiCGStab of 2 spaces (b = 1 and 2) at N_GRID^2; (g) GMRES(10) on the
    N_GRID^2 stencil and PCG(Jacobi) on (b)'s system; each one counted
    solve(N_ITERS) ((e), (f) and PCG: PROC_ITERS_E_G; GMRES: GMRES_CYCLES
    cycles), then a timed solve(PROC_TIMED) (GMRES: its cycles) after a
    warm-up one; (d) the f64
    golden; (h) ``entry.dryrun_multichip(PIECES)`` on the card (its own
    mesh: all on this process, or split over the processes of the group);
    (i) 3-D pieces at SHAPE3: the 7-point two-pass CG, counted
    solve(PROC_ITERS_E_G), one 27-point matvec of a seeded x, and
    BiCGStab step()s (3-D pieces have no fused runner), counted and timed
    over PROC_TIMED; (j) the 1-D view at N_GRID^2 ([N_GRID, N_GRID]): CG
    (two-pass: its s-step is not eligible on pieces) and the fused
    BiCGStab, solve(PROC_ITERS_E_G); (k) the scrambled PROC_DIA^2
    Laplacian through the RCM upgrade (its host build seconds, chain,
    windowed plan, the permutation's digest, one matvec of (b)'s x in the
    natural order), CG solve(N_ITERS) and the gathered x's digest.
    {key: numpy array} of this process's pieces (x: ``[spaces, n]``),
    launches as JSON."""
    import hashlib

    from legionsolvers_tpu_torch.entry import (
        build_explicit_system,
        build_stencil_system,
        dryrun_multichip,
    )

    digest = lambda a: np.array(hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).hexdigest())
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    f64 = lt.SolverOptions(entry_dtype=torch.float64)
    grid = (N_GRID, N_GRID)
    out = {}

    def solve(label, planner, make=lt.CGSolver, iters=N_ITERS,
              timed=PROC_TIMED):
        solver = make(planner)
        torch.cuda.synchronize()
        T.reset_launch_counts()
        h = solver.solve(iters)
        torch.cuda.synchronize()
        out[f"{label} launches"] = np.array(json.dumps(dict(T.LAUNCHES)))
        out[f"{label} hist"] = h.cpu().numpy()
        out[f"{label} x"] = np.stack([v.data.cpu().numpy().reshape(-1)
                                      for v in planner.sol_vectors])
        restart(solver)
        solver.solve(timed)  # its runner built before the clock
        restart(solver)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(timed)
        torch.cuda.synchronize()
        out[f"{label} ms"] = np.array(
            (time.perf_counter() - t0) * 1e3 / timed)
        T.reset_launch_counts()

    for label, switch in (("s-step", None),
                          ("two-pass", "LEGIONSOLVERS_NO_SSTEP")):
        with env_route(switch):
            solve(label, build_stencil_system(2, (N_GRID, N_GRID), f32,
                                              mesh=mesh))
    A = lt.create_coo_stencil_matrix((PROC_DIA, PROC_DIA),
                                     lt.laplacian_stencil(2), options=f32)
    n = PROC_DIA * PROC_DIA
    x = np.random.default_rng(PIECE_SEED).standard_normal(n) \
        .astype(np.float32)
    for label, switches in (("DIA", ()), ("ELL", ("LEGIONSOLVERS_NO_DIA",
                                                 "LEGIONSOLVERS_NO_RCM"))):
        with contextlib.ExitStack() as stack:
            for sw in switches:
                stack.enter_context(env_route(sw))
            planner = build_explicit_system(A, f32, mesh=mesh)
        op = planner.row_partitioned_matrices[0][0]
        out[f"{label} chain"] = np.array(json.dumps(chain(op)))
        out[f"{label} windowed"] = np.array(
            getattr(op, "_win", None) is not None)
        v = lt.PartitionedVector.from_array(
            "x", x, lt.BlockPartition(n, PIECES), mesh=mesh, options=f32,
            device=device)
        out[f"{label} matvec"] = op.matvec(v.data).cpu().numpy()
        solve(label, planner)
        del planner, op, v
    golden = build_explicit_system(
        lt.coo_negative_laplacian_1d(100, options=f64), f64, mesh=mesh)
    out["golden"] = lt.CGSolver(golden).solve(10).cpu().numpy()
    out["golden chain"] = np.array(json.dumps(chain(
        golden.row_partitioned_matrices[0][0])))
    del golden
    solve("BiCGStab", build_stencil_system(2, grid, f32, mesh=mesh),
          lt.BiCGStabSolver, PROC_ITERS_E_G)
    for label, make in (("block CG", lt.CGSolver),
                        ("block BiCGStab", lt.BiCGStabSolver)):
        planner = build_stencil_system(2, grid, f32, mesh=mesh,
                                       num_spaces=2)
        planner.rhs_vectors[1].constant_fill(2.0)
        solve(label, planner, make, PROC_ITERS_E_G)
        del planner
    solve("GMRES(10)", build_stencil_system(2, grid, f32, mesh=mesh),
          lambda p: lt.GMRESSolver(p, GMRES_RESTART), GMRES_CYCLES,
          GMRES_CYCLES)
    solve("PCG(Jacobi)", build_explicit_system(A, f32, mesh=mesh),
          lambda p: pcg_solver(lt, p), PROC_ITERS_E_G)
    # (i) 3-D pieces
    solve("3-D CG", build_stencil_system(3, SHAPE3, f32, mesh=mesh),
          iters=PROC_ITERS_E_G)
    op = build_stencil_system(4, SHAPE3, f32, mesh=mesh) \
        .row_partitioned_matrices[0][0]
    x3 = np.random.default_rng(PIECE_SEED).standard_normal(
        SHAPE3[0] * SHAPE3[1] * SHAPE3[2]).astype(np.float32)
    v = lt.PartitionedVector.from_array(
        "x", x3, lt.BlockPartition(x3.size, PIECES), mesh=mesh, options=f32,
        grid_shape=SHAPE3, device=device)
    torch.cuda.synchronize()
    T.reset_launch_counts()
    out["27-point matvec"] = op.matvec(v.data).reshape(-1).cpu().numpy()
    torch.cuda.synchronize()
    out["27-point launches"] = np.array(json.dumps(dict(T.LAUNCHES)))
    T.reset_launch_counts()
    del op, v, x3
    planner = build_stencil_system(3, SHAPE3, f32, mesh=mesh)
    out["3-D fused BiCGStab"] = np.array(bool(
        planner.row_partitioned_matrices[0][0].supports_fused_bicgstab))
    solve("3-D BiCGStab step()", planner, lt.BiCGStabSolver, PROC_TIMED)
    del planner
    # (j) the 1-D view
    grid1 = (N_GRID * N_GRID,)
    planner = build_stencil_system(1, grid1, f32, mesh=mesh)
    out["1-D s-step eligible"] = np.array(bool(
        planner.row_partitioned_matrices[0][0].step2_eligible))
    solve("1-D CG", planner, iters=PROC_ITERS_E_G)
    del planner
    solve("1-D BiCGStab", build_stencil_system(1, grid1, f32, mesh=mesh),
          lt.BiCGStabSolver, PROC_ITERS_E_G)
    # (k) the scrambled Laplacian in its RCM basis
    rows, cols, vals, n_s, _ = explicit_coo(np, lt, "scrambled")
    A = lt.COOMatrix(rows, cols, vals, n_s, n_s, options=f32)
    t0 = time.perf_counter()
    planner = build_explicit_system(A, f32, mesh=mesh)
    out["RCM build s"] = np.array(time.perf_counter() - t0)
    op = planner.row_partitioned_matrices[0][0]
    out["RCM chain"] = np.array(json.dumps(chain(op)))
    out["RCM windowed"] = np.array(
        getattr(getattr(op, "base", op), "_win", None) is not None)
    out["RCM perm"] = digest(planner.basis_perms[0]["perm_np"])
    v = lt.PartitionedVector.from_array(
        "x", x, lt.BlockPartition(n, PIECES), mesh=mesh, options=f32,
        device=device)
    out["RCM matvec"] = op.matvec(v.data).cpu().numpy()
    solve("RCM", planner)
    out["RCM x gathered"] = digest(planner.sol_vectors[0].to_numpy())
    del planner, op, v, A, rows, cols, vals
    t0 = time.perf_counter()
    line = io.StringIO()
    with contextlib.redirect_stdout(line):
        hists = dryrun_multichip(PIECES, device=device)
    out["dryrun s"] = np.array(time.perf_counter() - t0)
    out["dryrun line"] = np.array(line.getvalue().strip())
    for key, h in hists.items():
        out[f"dryrun {key}"] = h
    log(out["dryrun line"])
    return out


def proc_exchange_us(torch, device, mesh):
    """Host µs per call of the two helpers a pass of the 2-D CG crosses
    processes with, on this process's pieces: a shift of 4-row halos of
    r and p (``mesh.shift_pieces``) and a gather of Gram vectors
    (``mesh.gather_pieces``), PROC_REPS calls each after a warm-up."""
    from legionsolvers_tpu_torch.parallel.mesh import (
        gather_pieces,
        shift_pieces,
    )

    S = mesh.local_size
    halo = torch.ones(S, 2, 4, N_GRID, device=device)
    gram = torch.ones(S, 10, device=device)
    us = {}
    for name, fn in (("shift of 4-row halos", lambda: shift_pieces(
            mesh, halo, 1, wrap=False)),
                     ("gather of Gram vectors", lambda: gather_pieces(
                         mesh, gram))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROC_REPS):
            fn()
        torch.cuda.synchronize()
        us[name] = (time.perf_counter() - t0) * 1e6 / PROC_REPS
    return us


def proc_worker(torch, np, lt, T, build, rank, port, outdir,
                device="cuda:0"):
    """``--worker RANK PORT DIR``: one of PROC_RANKS processes of phase
    4p.  It loads the kernel library the parent built (and fails if that
    would start nvcc), joins the gloo group, builds the 4-shard mesh of
    its PIECES // PROC_RANKS local shards on the card, runs
    :func:`proc_runs` and writes ``DIR/rank<RANK>.npz``."""
    from legionsolvers_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_mesh,
    )

    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    if not build.library_path().exists():
        raise RuntimeError("the kernel library is not built: a worker "
                           "starts no nvcc")
    build.load_library()
    initialize_distributed(f"127.0.0.1:{port}", PROC_RANKS, rank)
    mesh = make_mesh(PIECES, devices=[device] * (PIECES // PROC_RANKS))
    assert mesh.spans_processes and mesh.rank == rank, mesh
    out = proc_runs(torch, np, lt, T, device, mesh)
    out["exchange us"] = np.array(json.dumps(proc_exchange_us(torch, device,
                                                              mesh)))
    out["local range"] = np.array(mesh.local_range)
    out["library"] = np.array(build.BUILD_INFO["log"])
    np.savez(pathlib.Path(outdir) / f"rank{rank}.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    log(f"[processes] worker {rank} done")
    return 0


def proc_start(outdir):
    """Start the PROC_RANKS workers (fresh interpreters, never a fork of
    this CUDA process) on a free loopback port; their (process, log
    file) pairs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(PROC_RANKS):
        f = open(pathlib.Path(outdir) / f"rank{r}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(port), str(outdir)], stdout=f, stderr=subprocess.STDOUT),
            f))
    return procs


def proc_finish(procs):
    """Wait for the workers, each within PROC_TIMEOUT_S of the start,
    killing all on a timeout; [(return code or "timeout", log tail)]."""
    t_end = time.perf_counter() + PROC_TIMEOUT_S
    res = []
    for p, f in procs:
        try:
            rc = p.wait(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        res.append(rc)
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tails = []
    for (p, f), rc in zip(procs, res):
        f.seek(0)
        tails.append((rc, f.read()[-3000:]))
        f.close()
    return tails


def processes_path(torch, np, lt, T, device, card):
    """Phase 4p: the main path over two processes.  The same runs
    (:func:`proc_runs`) on a one-process 4-piece mesh of the card, then in
    PROC_RANKS worker processes of this script (``--worker``), each with
    2 of the 4 shards on the same card, joined by
    ``initialize_distributed`` (gloo; NCCL refuses two ranks on one card).
    Held: (a) the s-step and the two-pass CG histories and x bit for bit
    the one-process mesh's, the history on both ranks, each process's
    K1/K2 (s-step) and K3/K4 (two-pass) launches half the one-process
    ones; (b) the DiaOperator and (c) the sharded ELL (windowed, K9): one
    matvec bit for bit, the solve(N_ITERS) history and x within twice
    textbook f32's distance from float64 CG (phase 4k's envelope) and
    equal on both ranks, half the launches; (d) the f64 golden exactly;
    (e) the fused 2-D BiCGStab and (f) block CG and block BiCGStab: as
    (a); (g) GMRES(10): history within PIECE_GMRES_RTOL of one process's
    (x logged), PCG(Jacobi) on (b)'s system: history and x within phase 4k's
    envelope of one process's and of float64 CG, both equal on both ranks,
    half the launches; (h) ``entry.entry()``'s step on the card (one K3
    y_dot launch) within PROC_ENTRY_RTOL of the same step on the CPU, and
    ``entry.dryrun_multichip(PIECES)`` across the workers: every section
    equal on both ranks, the fused ones bit for bit one process's, the
    others within PROC_DRYRUN_RTOL; (i) the 7-point 3-D CG on 3-D pieces
    (K6b + K6a per piece, the halo planes shifted across the processes):
    as (a), its K6a pq/update and K6b launches half; one 27-point matvec
    bit for bit one process's, half its K6a y launches; BiCGStab step()s
    on the 7-point stencil, no fused runner on 3-D pieces as on one
    process: the first entries within the eager bound of one process's
    (EAGER3_RTOL, phase 4j's), half the launches; (j) the 1-D view at
    N_GRID^2: the s-step not eligible on pieces, as on one process,
    two-pass CG and the fused BiCGStab as (a); (k) the scrambled
    PROC_DIA^2 Laplacian through the planner's RCM upgrade: the
    one-process chain (PROC_RCM_CHAIN, windowed) and permutation on every
    rank, one matvec in the natural order bit for bit one process's, CG
    solve(N_ITERS) within phase 4k's envelope of one process's and of
    float64 CG with x in the natural order, the same gathered x on both
    ranks, half the K9 launches; the host build seconds logged per rank.
    Every worker must finish within PROC_TIMEOUT_S with its results; there
    is no fallback to one process.  Prints each solve's ms/iter beside one
    process's and the host µs of the exchanges.  Returns (results,
    failed)."""
    from legionsolvers_tpu_torch.entry import entry
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    checks, results = {}, {}
    # (h) entry(): one CG step on the card, and the same step on the CPU
    fn, example = entry()
    torch.cuda.synchronize()
    T.reset_launch_counts()
    state, rr = fn(*example)
    torch.cuda.synchronize()
    launched = dict(T.LAUNCHES)
    T.reset_launch_counts()
    fn_c, example_c = entry(device="cpu")
    state_c, rr_c = fn_c(*example_c)
    x, x_c = state["sol"][0].cpu().double(), state_c["sol"][0].double()
    dev_rr = abs(float(rr) - float(rr_c)) / abs(float(rr_c))
    dev_x = ((x - x_c).abs().max() / x_c.abs().max()).item()
    checks[f"(h) entry(): one CG step on the card (K3 y_dot once), rr and "
           f"sol within {PROC_ENTRY_RTOL} of the step on the CPU"] = (
        launched == {"y_dot": 1} and dev_rr <= PROC_ENTRY_RTOL
        and dev_x <= PROC_ENTRY_RTOL)
    results["entry"] = {"launches": launched, "rr": float(rr),
                        "rr on the CPU": float(rr_c),
                        "vs the CPU (rr, sol)": (dev_rr, dev_x)}
    log(f"[processes] entry(): rr1 {float(rr):g} (CPU {float(rr_c):g}), "
        f"launches {launched}, vs the CPU {(dev_rr, dev_x)}")
    del fn, example, state, fn_c, example_c, state_c, x, x_c

    t0 = time.perf_counter()
    one_mesh = make_mesh(PIECES, devices=[device] * PIECES)
    ref = proc_runs(torch, np, lt, T, device, one_mesh)
    ref_us = proc_exchange_us(torch, device, one_mesh)
    t_ref = time.perf_counter() - t0
    # float64 CG and textbook f32's distance from it (phase 4k's envelope)
    # at each counted solve's length on the explicit systems
    f64_refs = {}
    for iters in (N_ITERS, PROC_ITERS_E_G):
        h64, x64 = classic_cg(torch, (PROC_DIA, PROC_DIA), iters,
                              torch.float64, device)
        h32, x32 = classic_cg(torch, (PROC_DIA, PROC_DIA), iters,
                              torch.float32, device)
        f64_refs[iters] = (h64, x64, max_rel(h32, h64), x_rel(x32, x64))
    del h64, x64, h32, x32
    torch.cuda.empty_cache()
    PROC_DIR.mkdir(parents=True, exist_ok=True)
    for f in PROC_DIR.glob("rank*"):
        f.unlink()
    t1 = time.perf_counter()
    tails = proc_finish(proc_start(PROC_DIR))
    t_workers = time.perf_counter() - t1
    results["one process"] = {k: v.tolist() for k, v in ref.items()
                              if k.endswith(" ms")}
    ranks = []
    for r, (rc, tail) in enumerate(tails):
        path = PROC_DIR / f"rank{r}.npz"
        ok = rc == 0 and path.exists()
        checks[f"worker {r} finished within {PROC_TIMEOUT_S} s with its "
               "results"] = ok
        if not ok:
            log(f"[processes] worker {r}: {rc}\n{tail}")
            continue
        with np.load(path) as f:
            ranks.append({k: f[k] for k in f.files})
        checks[f"worker {r} loaded the built library (no nvcc)"] = (
            str(ranks[-1]["library"]) == "(cached)")
    if len(ranks) == PROC_RANKS:
        whole = lambda key: np.concatenate([o[key] for o in ranks], -1)
        launches = lambda o, lab: json.loads(str(o[f"{lab} launches"]))
        bits = lambda a, b: a.dtype == b.dtype and a.shape == b.shape and (
            a.tobytes() == b.tobytes())
        for lab in PROC_LAUNCHES:
            part = PROC_PART[lab]
            tag = (f"({lab})" if part in "abcd"
                   else f"({part}) {lab}:")  # 4p's first checks' names
            want = launches(ref, lab)
            half = all(all(launches(o, lab).get(m, 0) * PROC_RANKS
                           == want.get(m, -1) > 0
                           for m in PROC_LAUNCHES[lab]) for o in ranks)
            checks[f"{tag} each process launches half of one process's "
                   f"{PROC_LAUNCHES[lab]}"] = half
            checks[f"{tag} the same history on every rank"] = all(
                bits(o[f"{lab} hist"], ranks[0][f"{lab} hist"])
                for o in ranks)
            res = {"launches per process": [launches(o, lab) for o in ranks],
                   "launches one process": want,
                   "ms/iter per process": [float(o[f"{lab} ms"])
                                           for o in ranks],
                   "ms/iter one process": float(ref[f"{lab} ms"])}
            h, x = ranks[0][f"{lab} hist"], whole(f"{lab} x")
            if lab in PROC_BITS:
                checks[f"({part}) {lab}: history and x bit for bit one "
                       "process's"] = (bits(h, ref[f"{lab} hist"])
                                       and bits(x, ref[f"{lab} x"]))
                res["history finite up to"] = int(
                    np.isfinite(h).cumprod().sum())
            elif lab == "3-D BiCGStab step()":
                dev = rel_dev(torch.from_numpy(h),
                              torch.from_numpy(ref[f"{lab} hist"]))
                res["vs one process (history)"] = dev.tolist()
                checks[f"(i) {lab}: no fused runner on 3-D pieces, as on "
                       "one process; the first three entries within "
                       f"{EAGER3_RTOL} of one process's (phase 4j's eager "
                       "bound)"] = (
                    not any(bool(o["3-D fused BiCGStab"])
                            for o in ranks + [ref])
                    and bool(np.isfinite(h).all()) and eager_ok(dev[:3]))
            elif lab == "GMRES(10)":
                ht, xt = torch.from_numpy(h), torch.from_numpy(x).double()
                x1 = torch.from_numpy(ref[f"{lab} x"]).double()
                res["vs one process (history, x)"] = (
                    max_rel(ht, torch.from_numpy(ref[f"{lab} hist"])),
                    x_rel(xt, x1))
                # 4j's rule for GMRES on pieces: the history (x moves
                # along the slowest modes, ~1e-3 of max|x|, and is logged)
                checks[f"(g) {lab}: history within {PIECE_GMRES_RTOL} of "
                       "one process's"] = (
                    bool(np.isfinite(h).all())
                    and res["vs one process (history, x)"][0]
                    <= PIECE_GMRES_RTOL)
            else:
                if lab != "PCG(Jacobi)":
                    want_chain = {"DIA": ["DiaOperator"],
                                  "RCM": PROC_RCM_CHAIN}.get(
                                      lab, ["RowPartitionedMatrix"])
                    name = f"({lab})" if part in "bc" else f"(k) {lab}:"
                    checks[f"{name} the planner picks {want_chain}"
                           + (", windowed (K9)" if lab != "DIA" else "")] = \
                        all(json.loads(str(o[f"{lab} chain"])) == want_chain
                            and (lab == "DIA" or bool(o[f"{lab} windowed"]))
                            for o in ranks + [ref])
                    checks[f"{name} one matvec bit for bit one "
                           "process's"] = bits(whole(f"{lab} matvec"),
                                               ref[f"{lab} matvec"])
                x_ref = ref[f"{lab} x"]
                if lab == "RCM":
                    # x in the scrambled system's natural order: x_s[pr[i]]
                    # is the unscrambled grid's x[i], float64 CG's order
                    pr = np.random.default_rng(0).permutation(x.shape[-1])
                    x, x_ref = x[:, pr], x_ref[:, pr]
                    checks["(k) RCM: the same permutation on every rank, "
                           "one process's"] = all(
                        str(o["RCM perm"]) == str(ref["RCM perm"])
                        for o in ranks)
                    checks["(k) RCM: the same gathered x on every rank"] = \
                        all(str(o["RCM x gathered"])
                            == str(ranks[0]["RCM x gathered"])
                            for o in ranks)
                    res["host build s per process"] = [
                        float(o["RCM build s"]) for o in ranks]
                    res["host build s one process"] = float(
                        ref["RCM build s"])
                ht, xt = torch.from_numpy(h), torch.from_numpy(x).to(device)
                h64, x64, env_t, env_x = f64_refs[len(h) - 1]
                dev_k = max_rel(ht.to(device), h64)
                dev_x = x_rel(xt, x64)
                res.update({
                    "vs float64 (history, x)": (dev_k, dev_x),
                    "textbook f32 vs float64": (env_t, env_x),
                    "vs one process (history, x)": (
                        max_rel(ht, torch.from_numpy(ref[f"{lab} hist"])),
                        x_rel(xt, torch.from_numpy(x_ref).to(device)
                              .double()))})
                checks[f"{tag} history and x within twice textbook f32's "
                       "distance from float64 (phase 4k's envelope)"] = (
                    bool(np.isfinite(h).all()) and bool(np.isfinite(x).all())
                    and dev_k <= max(2 * env_t, X_F64_FLOOR)
                    and dev_x <= max(2 * env_x, X_F64_FLOOR))
                if lab in ("PCG(Jacobi)", "RCM"):
                    # two f32 codes of one recurrence, their sums in other
                    # orders: held to each other by the same envelope
                    one_k, one_x = res["vs one process (history, x)"]
                    checks[f"{tag} history and x within phase 4k's "
                           "envelope of one process's"] = (
                        one_k <= max(2 * env_t, X_F64_FLOOR)
                        and one_x <= max(2 * env_x, X_F64_FLOOR))
            results[lab] = res
            if lab == "RCM":
                log(f"[processes] RCM: host build s per process "
                    f"{res['host build s per process']}, one process "
                    f"{res['host build s one process']:.2f}")
            log(f"[processes] {lab}: ms/iter per process "
                f"{res['ms/iter per process']}, one process "
                f"{res['ms/iter one process']:.4f}"
                + (" (per cycle)" if lab == "GMRES(10)" else "")
                + f"; launches per process "
                f"{res['launches per process']}, one process {want}"
                + (f"; vs float64 {res['vs float64 (history, x)']}, "
                   f"textbook f32 {res['textbook f32 vs float64']}"
                   if "vs float64 (history, x)" in res else "")
                + (f"; vs one process {res['vs one process (history, x)']}"
                   if "vs one process (history, x)" in res else "")
                + (f"; history finite up to {res['history finite up to']}"
                   if "history finite up to" in res else "")
                + f" on {card}")
        got27 = [json.loads(str(o["27-point launches"])) for o in ranks]
        one27 = json.loads(str(ref["27-point launches"]))
        checks["(i) 27-point: one matvec bit for bit one process's, each "
               "process's K6a y launches half of one process's"] = (
            bits(whole("27-point matvec"), ref["27-point matvec"])
            and one27 == {"y3d": PIECES}
            and all(g == {"y3d": PIECES // PROC_RANKS} for g in got27))
        results["27-point matvec launches"] = {"per process": got27,
                                               "one process": one27}
        checks["(j) 1-D: the s-step not eligible on pieces, as on one "
               "process (two-pass CG)"] = not any(
            bool(o["1-D s-step eligible"]) for o in ranks + [ref])
        checks["(d) the f64 golden exactly, on every rank and on one "
               "process, through the DiaOperator"] = all(
            o["golden"].tolist() == GOLDEN
            and json.loads(str(o["golden chain"])) == ["DiaOperator"]
            for o in ranks + [ref])
        # (h) the dry run across the workers
        dry = {}
        for key in (k[len("dryrun "):] for k in ref
                    if k.startswith("dryrun ") and k not in (
                        "dryrun s", "dryrun line")):
            a = [o[f"dryrun {key}"] for o in ranks]
            one = ref[f"dryrun {key}"]
            dev = float(np.max(np.abs(a[0] - one) / np.abs(one)))
            dry[key] = {"vs one process": dev, "bits": bits(a[0], one)}
            held = all(bits(o, a[0]) for o in a) and (
                bits(a[0], one) if key in PROC_DRYRUN_BITS
                else dev <= PROC_DRYRUN_RTOL)
            checks[f"(h) dryrun_multichip({PIECES}) {key}: equal on every "
                   "rank, " + ("bit for bit one process's"
                               if key in PROC_DRYRUN_BITS else
                               f"within {PROC_DRYRUN_RTOL} of one "
                               "process's")] = held
        results["dryrun"] = {
            "sections": dry, "lines": [str(o["dryrun line"]) for o in ranks],
            "line one process": str(ref["dryrun line"]),
            "s per process": [float(o["dryrun s"]) for o in ranks],
            "s one process": float(ref["dryrun s"])}
        for r, o in enumerate(ranks):
            log(f"[processes] rank {r}: {o['dryrun line']}")
        log(f"[processes] dryrun_multichip({PIECES}) vs one process: "
            + ", ".join(f"{k} {v['vs one process']:.3g}"
                        for k, v in dry.items()))
        results["exchange us"] = {
            "per process": [json.loads(str(o["exchange us"]))
                            for o in ranks], "one process": ref_us}
        log(f"[processes] host µs per call, per process "
            f"{results['exchange us']['per process']}, one process (device "
            f"copies) {ref_us} on {card}")
    results["seconds"] = {"one process": t_ref, "workers": t_workers}
    failed = [k for k, ok in checks.items() if not ok]
    results["checks"] = checks
    log(f"[processes] one process {t_ref:.1f} s, workers {t_workers:.1f} s; "
        f"checks: {len(checks) - len(failed)} of {len(checks)} hold"
        + (f"; FAILED: {failed}" if failed else ""))
    for f in PROC_DIR.glob("rank*.npz"):
        f.unlink()
    return results, failed


def build_seconds(torch, np, lt, device):
    """``--builds``: the host seconds of phase 4e-g's three builds and 4k's
    four (each build's matrix and planner seconds), with the library
    loaded or not (LEGIONSOLVERS_NO_NATIVE), and the operator chains and
    geometries they pick, logged also where they are not the ones the
    phases check."""
    from legionsolvers_tpu_torch.native import bindings as TN
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    out = {"library": TN.available()}
    mesh = make_mesh(PIECES, devices=[device] * PIECES)
    one = {}
    for name in EXPLICIT:
        try:
            one[name] = build_explicit(torch, np, lt, name, device)
            out[name] = one[name]["host_s"]
        except AssertionError as e:
            out[name] = str(e)
    for name, (system, _) in XP_BUILDS.items():
        try:
            b = build_explicit_pieces(torch, np, lt, name, device, mesh,
                                      one.get(system))
            out[f"{name} on {PIECES} pieces"] = b["host_s"]
            del b
        except AssertionError as e:
            out[f"{name} on {PIECES} pieces"] = str(e)
    return out


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               nflops, bw, library_ms=None, op_rate=F32_PEAK,
               grid_launches=None):
    """One entry of the kernels line: bound_ms is the larger of the bytes
    over the measured copy bandwidth and the operations over their peak
    rate (``op_rate``: the card's f32 peak, or K11 roll's and row's
    shared-memory steps per second); pct_of_bound is bound_ms over ms;
    ms_lost is launches x (ms - bound_ms), over the main path's launches
    in whole-grid launches (``grid_launches``, where launches on pieces
    count 1/S each; default ``launches``)."""
    t_bytes = nbytes / bw * 1e3
    t_ops = nflops / op_rate * 1e3
    bound = max(t_bytes, t_ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": library_ms, "pct_of_bound": 100 * bound / ms}
    if grid_launches is None:
        grid_launches = launches
    else:
        row["whole_grid_launches"] = grid_launches
    row["ms_lost"] = grid_launches * (ms - bound)
    return row


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    if "--ab" in argv:
        return ab_solves(argv[argv.index("--ab") + 1], torch)
    if "--tree" in argv:  # import the package of another tree
        tree = os.path.abspath(argv[argv.index("--tree") + 1])
        os.chdir(tree)
        sys.path.insert(0, tree)
    try:
        import numpy as np
        import legionsolvers_tpu_torch as lt
        from legionsolvers_tpu_torch.ops.cuda import build
        from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
        from legionsolvers_tpu_torch.ops.cuda import bicgstab3d as TB3
        from legionsolvers_tpu_torch.ops.cuda import stencil2d as T
        from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    if argv and argv[0] == "--worker":  # one process of phase 4p
        return proc_worker(torch, np, lt, T, build, int(argv[1]),
                           int(argv[2]), argv[3])

    torch.cuda.set_device(0)
    device = "cuda:0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_run = time.perf_counter()
    mark = lambda what: log(f"[elapsed] {what}: "
                            f"{time.perf_counter() - t_run:.1f} s")
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log(f"[build] {build.BUILD_INFO['path']} in {build_s:.1f} s "
        f"(nvcc {build.BUILD_INFO['seconds']:.1f} s)")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")
    if "--solves" in argv:
        return solves(torch, np, T, lt, device, card)
    if "--passes" in argv:
        log(json.dumps({"card": card, "tree": os.getcwd(), "kernels2d_ms":
                         time_ab_passes_2d(torch, T, TB, device)}))
        return 0
    if "--blocks" in argv:
        blk_launches, blk_results, blk_solvers, failed = block_path(
            torch, T, TB, T3, TB3, lt, device)
        times = time_block_solves(torch, blk_solvers,
                                  copy_bandwidth(torch, device), card)
        log(json.dumps({"card": card, "launches": {
            str(k): v for k, v in blk_launches.items()},
            "paths": blk_results, "times": times}, default=str))
        return 1 if failed else 0
    if "--pieces" in argv:
        pc_launches, _, pc_results, pc_solvers, failed = pieces_path(
            torch, np, T, TB, T3, TB3, lt, device)
        ps_launches, _, ps_results, ps_solvers, f = pieces_solvers_path(
            torch, np, T, TB, T3, TB3, lt, device)
        failed += f
        bw = copy_bandwidth(torch, device)
        times = time_piece_solves(torch, pc_solvers, bw, card)
        wrappers = wrapper_host_us(torch, T, device, card)
        glue_host_us(times, wrappers)
        ps_times = time_piece_solvers(torch, ps_solvers, bw, card)
        profile_piece_solves(torch, pc_solvers, times, card)
        profile_piece_solvers(torch, ps_solvers, ps_times, card)
        log(json.dumps({"card": card, "launches": {
            str(k): v for k, v in {**pc_launches, **ps_launches}.items()},
            "paths": {**pc_results, **ps_results},
            "times": {**times, **ps_times}, "wrapper host us": wrappers},
            default=str))
        return 1 if failed else 0
    if "--explicit-pieces" in argv:
        one_piece = {}
        for name in ("dia", "scrambled"):
            sysd = build_explicit(torch, np, lt, name, device)
            one_piece[name] = (sysd, lt.CGSolver(sysd["planner"]))
        xp_launches, _, xp_results, xp_solvers, xp_builds, failed = \
            explicit_pieces_path(torch, np, T, lt, device, one_piece)
        xp_times = time_explicit_pieces(torch, xp_solvers,
                                        copy_bandwidth(torch, device), card)
        log(json.dumps({"card": card, "launches": xp_launches,
                        "paths": xp_results, "times": xp_times,
                        "host_s": {k: v["host_s"] for k, v in
                                   xp_builds.items()}}, default=str))
        return 1 if failed else 0
    if "--utils" in argv:
        ut_results, failed = utils_path(torch, np, lt, T, device, card)
        mark("phase 4o")
        log(json.dumps({"card": card, "utils": ut_results}, default=str))
        return 1 if failed else 0
    if "--processes" in argv:
        pp_results, failed = processes_path(torch, np, lt, T, device, card)
        mark("phase 4p")
        log(json.dumps({"card": card, "processes": pp_results}, default=str))
        return 1 if failed else 0
    if "--builds" in argv:
        log(json.dumps({"card": card, "host_s": build_seconds(
            torch, np, lt, device)}, default=str))
        return 0
    if "--flat1d" in argv:
        fl_attrs = flat_attrs(build.load_library())
        errs_f, errs_w = compare_flat_kernels(torch, T, TB, device)
        fl_launches, fl_grid, fl_results, fl_solvers, failed = flat1d_path(
            torch, np, T, TB, lt, device)
        mark("phase 4l")
        bw = copy_bandwidth(torch, device)
        ftimes, wtimes, fsolves = time_flat1d(torch, T, TB, device, bw, card,
                                              fl_solvers)
        mark("phase 5l")
        conv1d_ms = library_1d(torch, T, device, card)
        rows = flat1d_rows(T, fl_launches, fl_grid, errs_f, ftimes, bw,
                           conv1d_ms, fl_attrs, wtimes)
        log(json.dumps({"card": card, "flat1d": {
            "paths": fl_results, "solves": fsolves, "wide_errs": errs_w,
            "wide_ms": wtimes, "kernels": rows}}, default=str))
        if failed:
            raise AssertionError(f"checks failed: {failed}")
        return 0
    if "--wide3d" in argv:
        m3_attrs = wide3d_attrs(build.load_library(), T3)
        errs_z = compare_wide3d_kernels(torch, T3, TB3, device)
        nop_err = compare_nop(torch, T, device)
        wz_launches, wz_grid, wz_results, wz_solvers, failed = wide3d_path(
            torch, T, T3, TB3, lt, device)
        mark("phase 4m")
        bw = copy_bandwidth(torch, device)
        ztimes, zsolves = time_wide3d(torch, T3, TB3, device, bw, card,
                                      wz_solvers)
        conv_ms, conv_why = library_wide3d(torch, T3, device, card)
        nop_times = time_nop(torch, T, device, bw, card)
        mark("phase 5m")
        rows = wide3d_rows(wz_launches, wz_grid, errs_z, ztimes, bw, conv_ms,
                           conv_why, m3_attrs)
        rows.append(nop_row(nop_err, nop_times, bw))
        log(json.dumps({"card": card, "wide3d": {
            "paths": wz_results, "solves": zsolves, "kernels": rows,
            "nop_ms": nop_times}}, default=str))
        if failed:
            raise AssertionError(f"checks failed: {failed}")
        return 0
    if "--wide2d" in argv:
        gattrs = general_attrs(torch, build.load_library(), T)
        errs_g, k2_ulps = compare_general_kernels(torch, T, device)
        gn_launches, gn_grid, gn_results, gn_solvers, failed = general_path(
            torch, np, T, TB, lt, device)
        battrs = band_attrs(build.load_library(), T)
        errs_b = compare_band_kernels(torch, T, device)
        errs_k5 = compare_band_k5(torch, T, TB, device)
        bd_launches, bd_grid, bd_results, bd_solvers, f = band_path(
            torch, np, T, TB, lt, device)
        failed += f
        mark("phase 4n")
        bw = copy_bandwidth(torch, device)
        gtimes, gsolves = time_general(torch, T, device, bw, card,
                                       gn_solvers)
        band_times = time_band(torch, T, device, bw, card)
        k5_times = time_band_k5(torch, T, TB, device, bw, card)
        k5_solves = time_band_solves(torch, TB, bd_solvers, bw, card)
        conv_b = library_band(torch, T, device, card)
        mark("phase 5n")
        rows = general_rows(gn_results, errs_g, gtimes, bw, gattrs)
        rows += band_rows(bd_results, errs_b, band_times, bw, battrs, conv_b)
        rows += band_k5_rows(T, bd_results, errs_k5, k5_times, bw, battrs)
        log(json.dumps({"card": card, "wide2d": {
            "paths": {**gn_results, **bd_results}, "solves": gsolves,
            "k2_band_vs_coop_ulps": k2_ulps,
            "bicgstab_solves": k5_solves, "kernels": rows}}, default=str))
        if failed:
            raise AssertionError(f"checks failed: {failed}")
        return 0
    if "--band-accuracy" in argv:
        band_accuracy(torch, lt, T, device, card)
        return 0
    if "--bicg-gap" in argv:
        return bicg_gap_draws(torch, lt, TB, device, card)
    if "--breakdown" in argv:
        dim = int(argv[argv.index("--dim") + 1]) if "--dim" in argv else 3
        n = (int(argv[argv.index("--size") + 1]) if "--size" in argv
             else N_GRID)
        return breakdown(torch, lt, device, card, dim, n)
    m1_attrs = march1_attrs(build.load_library())
    log("[march1] registers, spill bytes, resident blocks per SM: "
        + "; ".join(f"{k} {v}" for k, v in m1_attrs.items()))
    m3_attrs = wide3d_attrs(build.load_library(), T3)
    s_attrs = strip_attrs(build.load_library())
    log("[strip2d] registers, spill bytes, resident blocks per SM: "
        + "; ".join(f"{k} {v}" for k, v in s_attrs.items()))

    errs = compare_kernels(torch, T, device)
    errs["step2"] = max(errs["step2"], compare_step2_edges(torch, T, device))
    errs.update(compare_bicg_kernels(torch, T, TB, device))
    for m, e in compare_strip_edges(torch, T, TB, device).items():
        errs[m] = max(errs[m], e)
    for m, e in compare_one_pass_edges(torch, T, device).items():
        errs[m] = max(errs[m], e)
    one_launch2 = check_one_launch_2d(torch, T, TB, device)
    errs3 = compare_3d_kernels(torch, lt, T3, TB3, device)
    one_launch3 = check_one_launch_3d(torch, lt, T3, TB3, device)
    errs_h = compare_probe_kernels(torch, device)
    mark("phases 3-3h")
    counts, results, solver = main_path(torch, np, T, lt, device)
    bcounts, bresults, bsolver, failed = bicgstab_path(torch, T, TB, lt,
                                                       device)
    counts3, results3, solvers3 = {}, {}, {}
    for dim in DIMS3:
        for kind3, path in (("cg", cg3d_path), ("bicg", bicg3d_path)):
            c, r, slv, f = path(torch, T, lt, device, dim)
            counts3[kind3, dim], solvers3[kind3, dim] = c, slv
            results3[f"{kind3} dim {dim}"] = r
            failed += f
    mark("phases 4-4d")
    blk_launches, blk_results, blk_solvers, f = block_path(
        torch, T, TB, T3, TB3, lt, device)
    failed += f
    mark("phase 4i")
    pc_launches, pc_grid, pc_results, pc_solvers, f = pieces_path(
        torch, np, T, TB, T3, TB3, lt, device)
    failed += f
    mark("phase 4j, 2-D CG on pieces")
    ps_launches, ps_grid, ps_results, ps_solvers, f = pieces_solvers_path(
        torch, np, T, TB, T3, TB3, lt, device)
    failed += f
    mark("phase 4j")
    systems = {name: build_explicit(torch, np, lt, name, device)
               for name in EXPLICIT}
    mark("phase 4e-g, the builds")
    errs_x = compare_explicit_kernels(torch, np, lt, T, systems, device)
    compare_blockperm_caps(torch, device)
    counts_x, results_x, solvers_x = {}, {}, {}
    runs = [("cg", name, systems[name]) for name in EXPLICIT]
    # BiCGStab on the random system as the entry point built it; it takes
    # the planner's workspace over (the CG solver on it keeps working: its
    # vectors are among BiCGStab's, and every restart derives them anew)
    runs.append(("bicgstab", "random", systems["random"]))
    for kind_x, name, sysd in runs:
        refs, true_rr = explicit_refs(torch, np, sysd, name, device, kind_x)
        if kind_x == "bicgstab":
            sysd["planner"].workspace_vectors = []
        c, r, slv, f = explicit_path(torch, T, lt, name, sysd, refs, true_rr,
                                     device, kind_x)
        counts_x[kind_x, name] = c
        results_x[f"{kind_x} {name}"] = r
        if kind_x == "cg":
            solvers_x[name] = slv
            sysd["refs"] = (refs, true_rr)  # phase 4k's references too
        failed += f
        del refs
    mark("phases 3e, 4e-g")
    xp_launches, xp_grid, xp_results, xp_solvers, xp_builds, f = \
        explicit_pieces_path(torch, np, T, lt, device, {
            k: (systems[k], solvers_x[k]) for k in EXPLICIT})
    failed += f
    mark("phase 4k")
    ut_results, f = utils_path(torch, np, lt, T, device, card)
    failed += f
    mark("phase 4o")
    pp_results, f = processes_path(torch, np, lt, T, device, card)
    failed += f
    mark("phase 4p")
    fl_attrs = flat_attrs(build.load_library())
    errs_f, errs_w = compare_flat_kernels(torch, T, TB, device)
    fl_launches, fl_grid, fl_results, fl_solvers, f = flat1d_path(
        torch, np, T, TB, lt, device)
    failed += f
    mark("phase 4l")
    errs_z = compare_wide3d_kernels(torch, T3, TB3, device)
    nop_err = compare_nop(torch, T, device)
    wz_launches, wz_grid, wz_results, wz_solvers, f = wide3d_path(
        torch, T, T3, TB3, lt, device)
    failed += f
    mark("phase 4m")
    gattrs = general_attrs(torch, build.load_library(), T)
    errs_g, k2_ulps = compare_general_kernels(torch, T, device)
    gn_launches, gn_grid, gn_results, gn_solvers, f = general_path(
        torch, np, T, TB, lt, device)
    failed += f
    battrs = band_attrs(build.load_library(), T)
    errs_b = compare_band_kernels(torch, T, device)
    errs_k5 = compare_band_k5(torch, T, TB, device)
    bd_launches, bd_grid, bd_results, bd_solvers, f = band_path(
        torch, np, T, TB, lt, device)
    failed += f
    mark("phase 4n")
    counts_h, cli_results, probes, cli_bw = cli_path(torch, np, T, lt,
                                                     device, card)
    cli_checked = cli_checks(torch, np, lt, device)
    mark("phase 4h")
    bw_copy = copy_bandwidth(torch, device)
    ptimes, k12_bw, k12_ms = time_probes(torch, device, card)
    # K12 may stream faster than copy_: every bound takes the faster one
    bw = max(bw_copy, k12_bw)
    log(f"[time] copy bandwidth {bw_copy / 1e9:.1f} GB/s (copy_), "
        f"{k12_bw / 1e9:.1f} GB/s (K12); bounds use {bw / 1e9:.1f} GB/s on "
        f"{card}")
    ktimes = time_kernels(torch, T, device, bw, card)
    btimes = time_bicg_kernels(torch, TB, device, bw, card)
    bsolve_ms = time_bicg_solve(torch, TB, bsolver, bw, card)
    solve_ms = time_solve(torch, T, solver, bw, card)
    conv2d_ms = library_2d(torch, T, device, card)
    ktimes3, conv3d_ms, gtimes3 = time_3d_kernels(torch, lt, T3, TB3,
                                                  device, bw, card)
    pv_turns = time_pv_turns(torch, lt, T3, TB3, device, card)
    solve3 = time_3d_solves(torch, T3, TB3, solvers3, bw, card)
    ktimes_x, solve_x, extra_x = time_explicit(torch, np, lt, systems,
                                               solvers_x, bw, card, device)
    mark("phase 5 to 5g")
    rates = time_rates(torch, device, card)
    cli_report = report_cli(torch, cli_results, probes, device, bw, card)
    nop_times = time_nop(torch, T, device, bw, card)
    mark("phase 5h")
    piece_times = time_piece_solves(torch, pc_solvers, bw, card)
    piece_wrappers = wrapper_host_us(torch, T, device, card)
    glue_host_us(piece_times, piece_wrappers)
    mark("phase 5j, 2-D CG on pieces")
    solver_times = time_piece_solvers(torch, ps_solvers, bw, card)
    mark("phase 5j, the solvers on pieces")
    block_times = time_block_solves(torch, blk_solvers, bw, card)
    mark("phase 5i")
    profile_piece_solves(torch, pc_solvers, piece_times, card)
    profile_piece_solvers(torch, ps_solvers, solver_times, card)
    mark("phase 5j")
    xp_times = time_explicit_pieces(torch, xp_solvers, bw, card)
    mark("phase 5k")
    ftimes, wtimes, fsolves = time_flat1d(torch, T, TB, device, bw, card,
                                          fl_solvers)
    conv1d_ms = library_1d(torch, T, device, card)
    mark("phase 5l")
    ztimes, zsolves = time_wide3d(torch, T3, TB3, device, bw, card,
                                  wz_solvers)
    conv_ms, conv_why = library_wide3d(torch, T3, device, card)
    mark("phase 5m")
    gtimes, gsolves = time_general(torch, T, device, bw, card, gn_solvers)
    band_times = time_band(torch, T, device, bw, card)
    k5_times = time_band_k5(torch, T, TB, device, bw, card)
    k5_solves = time_band_solves(torch, TB, bd_solvers, bw, card)
    conv_b = library_band(torch, T, device, card)
    mark("phase 5n")
    if "--profile" in sys.argv[1:]:  # last: tracing slows later launches
        profile_solve(torch, bsolver, "bicgstab_2d", card)
        for (kind3, dim), slv in solvers3.items():
            profile_solve(torch, slv, f"{kind3}_3d_dim{dim}", card)
        for name, slv in solvers_x.items():
            profile_solve(torch, slv, f"cg_explicit_{name}", card,
                          solve_x[name][0] * N_ITERS)
        for label, argv in CLI_RUNS.items():
            cli_report[f"profile {label}"] = profile_cli(torch, lt, label,
                                                         argv, card)
    mark("all phases")
    if failed:
        raise AssertionError(f"checks failed: {failed}")

    launches = {m: counts.get(m, 0) + bcounts.get(m, 0)
                for m in (*KERNELS, *BICG_KERNELS)}
    for dim in DIMS3:
        for m in (*KERNELS3, *BICG3_KERNELS):
            launches[m, dim] = (counts3["cg", dim].get(m, 0)
                                + counts3["bicg", dim].get(m, 0))
    launches.update(
        dia2d=counts_x["cg", "dia"].get("dia2d", 0),
        dia2d_dot=counts_x["cg", "dia"].get("dia2d_dot", 0),
        winell=counts_x["cg", "scrambled"].get("winell", 0),
        blockperm=(counts_x["cg", "random"].get("blockperm", 0)
                   + counts_x["bicgstab", "random"].get("blockperm", 0)))
    launches.update({m: counts_h.get(m, 0) for m in (
        "chain_fma", "chain_roll", "chain_row", "copy_probe")})
    # the block path's launches (phase 4i), K1-K7 per space, and the
    # pieces' (phase 4j), K1-K4 per piece; ms_lost takes a launch on one of
    # S pieces as 1/S of a whole-grid launch
    grid_launches = dict(launches)
    for m, c in blk_launches.items():
        launches[m] = launches.get(m, 0) + c
        grid_launches[m] = grid_launches.get(m, 0) + c
    on_pieces = {}
    for counts, grids in ((pc_launches, pc_grid), (ps_launches, ps_grid),
                          (xp_launches, xp_grid)):
        for m, c in counts.items():
            launches[m] = launches.get(m, 0) + c
            grid_launches[m] = grid_launches.get(m, 0) + grids[m]
            on_pieces[m] = on_pieces.get(m, 0) + c
    missing = [m for m, c in launches.items() if not c]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    n2, n3 = N_GRID * N_GRID, SHAPE3[0] * SHAPE3[1] * SHAPE3[2]
    kernels = [kernel_row(
        f"{KERNELS[m][0]} [{m}]", CSRC, f"{PALLAS}:{KERNELS[m][1]}",
        launches[m], errs[m], ktimes[m][0], ktimes[m][1],
        KERNELS[m][2] * n2, ops_per_elt(m, len(OFFS)) * n2, bw,
        conv2d_ms if m == "y" else None, grid_launches=grid_launches[m])
        for m in KERNELS]
    for m, row in zip(KERNELS, kernels):
        row["graph_ms"] = ktimes[m][2]
    kernels += [kernel_row(
        m, k5_route(T, m, KW, N_GRID)[1], f"{BICG_PALLAS}:{line}",
        launches[m], errs[m], btimes[m][False][0], btimes[m][False][1],
        bpe * n2, ops_per_elt(m, len(OFFS)) * n2, bw)
        for m, (line, bpe) in BICG_KERNELS.items()]
    for row, m in zip(kernels[-len(BICG_KERNELS):], BICG_KERNELS):
        row["kernel_route"] = k5_route(T, m, KW, N_GRID)[0]
    # the strip kernels' registers (the main path's variant: the cross,
    # vector loads, f32 dots)
    for row in kernels:
        m = row["name"].split(" ")[-1].strip("[]")
        if m in ("bicg_st", "gram2", *ONE_PASS_NAMES):
            regs, spill, _ = s_attrs[f"{m} cross vec"]
            row.update(registers=regs, spill_bytes=spill)
        if m in ONE_PASS_NAMES:
            per = {path: n[m] for path, n in PATH_LAUNCHES_2D.items()
                   if m in n}
            lost = row["ms"] - row["bound_ms"]
            log(f"[time] {m:8s} {row['ms']:.4f} ms (CUDA graphs "
                f"{row['graph_ms']:.4f}), bound {row['bound_ms']:.4f} "
                f"({row['pct_of_bound']:.1f}%; graphs "
                f"{100 * row['bound_ms'] / row['graph_ms']:.1f}%), "
                f"{row['registers']} registers; per solve(200): "
                + ", ".join(f"{path} {k} launches, {k * lost:.2f} ms lost"
                            for path, k in per.items()) + f" on {card}")
    for dim in DIMS3:
        pts, terms = {3: (7, 7), 4: (27, 27)}[dim]
        rows3 = [kernel_row(
            f"{KERNELS3[m][0]} [{m}] {pts}-point", CSRC3,
            f"{PALLAS3}:{KERNELS3[m][1]}", launches[m, dim], errs3[m, dim],
            *ktimes3[m, dim, False], KERNELS3[m][2] * n3,
            ops_per_elt(m, terms) * n3, bw,
            conv3d_ms[dim] if m == "y3d" else None) for m in KERNELS3]
        rows3 += [kernel_row(
            f"{m} {pts}-point", BICG3_CSRC, f"{BICG3_PALLAS}:{line}",
            launches[m, dim], errs3[m, dim], *ktimes3[m, dim, False],
            bpe * n3, ops_per_elt(m, terms) * n3, bw)
            for m, (line, bpe) in BICG3_KERNELS.items()]
        # device time alone, and the main path's march1 variant's registers
        # (vector loads: Z % 4 == 0)
        for m, row in zip((*KERNELS3, *BICG3_KERNELS), rows3):
            row["graph_ms"] = gtimes3[m, dim, False]
            if m in MARCH1_PASSES:
                regs, spill, _ = m1_attrs[
                    f"{M1_ATTR_NAMES[m]} {'star' if dim == 3 else 'box'} vec"]
                row.update(registers=regs, spill_bytes=spill)
        kernels += rows3
    for m, (row, source, replaces) in KERNELS_X.items():
        ms, plain_ms, nbytes, nflops, lib_ms = ktimes_x[m]
        kernels.append(kernel_row(f"{row} [{m}]", source, replaces,
                                  launches[m], errs_x[m], ms, plain_ms,
                                  nbytes, nflops, bw, lib_ms,
                                  grid_launches=grid_launches[m]))
        # the launches on pieces (phase 4k) within the row's launches
        kernels[-1]["pieces_launches"] = on_pieces.get(m, 0)
    # K10 and torch.take also in CUDA graphs (device time alone)
    kernels[-1]["graph_ms"], kernels[-1]["library_graph_ms"] = \
        extra_x["K10_graph_ms"]
    # K11: fma's bound is its flops at the f32 peak; roll's and row's their
    # chain steps at the shared-memory rate, every SM's SMEM_B_PER_CLOCK at
    # the maximum SM clock over 8 B per step
    n_tile, clock = 256 * 1024, max_sm_clock_hz()
    steps = 64 * K11_ROW_REPS * n_tile
    step_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                 * SMEM_B_PER_CLOCK / 8 * clock)
    log(f"[time] K11 roll/row ceiling {step_rate:.4g} steps/s "
        f"(clocks.max.sm {clock / 1e6:.0f} MHz) on {card}")
    for k11 in ("fma", "roll", "row"):
        m = f"chain_{k11}"
        kernels.append(kernel_row(
            f"chain_probe [{k11}] ({K11_ROW_REPS} trips)", K11_CSRC,
            K11_PALLAS, launches[m], errs_h[m], *ptimes[m][:2], 8 * n_tile,
            *((2 * steps, bw) if k11 == "fma" else
              (steps, bw, None, step_rate))))
    n12 = K12_SHAPES[0][0] * K12_SHAPES[0][1]
    kernels.append(kernel_row(
        "copy_probe", K12_CSRC, K12_PALLAS, launches["copy_probe"],
        errs_h["copy_probe"], *ptimes["copy_probe"][:2], 8 * n12, n12, bw,
        ptimes["copy_probe"][2]))
    # the launches on pieces (phase 4j) within each row's launches
    keys = ([*KERNELS, *BICG_KERNELS]
            + [(m, d) for d in DIMS3 for m in (*KERNELS3, *BICG3_KERNELS)])
    for row, key in zip(kernels, keys):
        row["pieces_launches"] = on_pieces.get(key, 0)
    # the 1-D view's routes (phase 4l): their launches on one piece and on
    # pieces, times at [4096, 4096] (phase 5l)
    flat_rows = flat1d_rows(T, fl_launches, fl_grid, errs_f, ftimes, bw,
                            conv1d_ms, fl_attrs, wtimes)
    for row, m in zip(flat_rows, (*KERNELS, *BICG_KERNELS)):
        row["pieces_launches"] = sum(
            fl_results[name]["launches"].get(m, 0)
            for name, run in FLAT_RUNS.items() if run[2] > 1)
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on the 1-D "
                                 "path")
    kernels += flat_rows
    # the wide-z route (phase 4m): launches on one piece and on pieces,
    # times at 256^3 (phase 5m); K1 nop, which no path runs (phase 5h)
    wide_rows = wide3d_rows(wz_launches, wz_grid, errs_z, ztimes, bw,
                            conv_ms, conv_why, m3_attrs)
    for row, m in zip(wide_rows, WIDE3_PASSES):
        row["pieces_launches"] = sum(
            wz_results[name]["launches"].get(m, 0)
            for name, run in WIDE3_RUNS.items() if run[1] > 1)
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "wide-z path")
    kernels += wide_rows
    kernels.append(nop_row(nop_err, nop_times, bw))
    # the general route of K1 and K2 (phase 4n): launches on one piece, on
    # pieces and in the block, times at 4096^2 (phase 5n)
    kernels += general_rows(gn_results, errs_g, gtimes, bw, gattrs)
    # the band route of K3 and K4 (phase 4n): launches on one piece and on
    # pieces, times at 4096^2 (phase 5n)
    kernels += band_rows(bd_results, errs_b, band_times, bw, battrs,
                         conv_b)
    # K5a-c on the band route, in phase 4n's
    # BiCGStab runs (one piece, 4 pieces; times at 4096^2, phase 5n)
    kernels += band_k5_rows(T, bd_results, errs_k5, k5_times, bw, battrs)
    report = {"card": card, "kind": kind, "build_s": build_s,
              "copy_GBps": bw_copy / 1e9, "k12_GBps": k12_bw / 1e9,
              "k12_turns_ms": k12_ms,
              "bound_GBps": bw / 1e9, "kernels": kernels,
              "bicg_kernel_ms": {m: {str(c): t for c, t in v.items()}
                                 for m, v in btimes.items()},
              "solve200_ms_per_iter": solve_ms, "main_path": results,
              "bicgstab_solve200_ms_per_iter": bsolve_ms,
              "bicgstab_path": bresults,
              "kernel3d_ms": {f"{m} dim {d} compensated={c}": t
                              for (m, d, c), t in ktimes3.items()},
              "kernel3d_graph_ms": {f"{m} dim {d} compensated={c}": t
                                    for (m, d, c), t in gtimes3.items()},
              "conv3d_ms": conv3d_ms, "conv2d_ms": conv2d_ms,
              "conv1d_ms": conv1d_ms,
              "pv_turns_ms": {str(k): v for k, v in pv_turns.items()},
              "solve3d_ms_per_iter": {f"{k} dim {d} {lab}": t for
                                      (k, d, lab), t in solve3.items()},
              "paths3d": results3, "march1_attrs": m1_attrs,
              "strip_attrs": s_attrs, "kernels2d_launched": one_launch2,
              "kernels3d_launched": one_launch3,
              "explicit": {
                  "systems": {k: {"host_s": v["host_s"], "nnz": v["nnz"],
                                  "geometry": v["geometry"]}
                              for k, v in systems.items()},
                  "paths": results_x,
                  "solve200_ms_per_iter": solve_x,
                  "kernel_ms": {k: v[:2] + v[4:] for k, v in
                                ktimes_x.items()},
                  **extra_x},
              "block": {"paths": blk_results, "times": block_times},
              "pieces": {"paths": pc_results, "times": piece_times,
                         "wrapper_host_us": piece_wrappers,
                         "solvers": {"paths": ps_results,
                                     "times": solver_times},
                         "explicit": {
                             "paths": xp_results, "times": xp_times,
                             "systems": {k: {"host_s": v["host_s"],
                                             "nnz": v["nnz"],
                                             "geometry": v["geometry"]}
                                         for k, v in xp_builds.items()}}},
              "flat1d": {"paths": fl_results, "solves": fsolves,
                         "kernel_ms": {k: v for k, v in ftimes.items()},
                         "wide_errs": errs_w, "wide_ms": wtimes},
              "wide3d": {"paths": wz_results, "solves": zsolves,
                         "kernel_ms": {f"{m} compensated={c}": t
                                       for (m, c), t in ztimes.items()},
                         "conv3d_ms": conv_ms, "conv3d_note": conv_why},
              "nop_ms": nop_times,
              "utils": ut_results,
              "processes": pp_results,
              "band": {"paths": bd_results,
                       "kernel_ms": {f"{m} {st}": t for
                                     (m, st), t in band_times.items()},
                       "k5_kernel_ms": {f"{m} {st}": t for
                                        (m, st), t in k5_times.items()},
                       "bicgstab_solves": k5_solves,
                       "attrs": {f"{m} {st}": v for
                                 (m, st), v in battrs.items()},
                       "conv2d_ms": conv_b},
              "general": {"paths": gn_results, "solves": gsolves,
                          "k2_band_vs_coop_ulps": k2_ulps,
                          "kernel_ms": {f"{m} {kind} {st}": t for
                                        (m, kind, st), t in gtimes.items()},
                          "attrs": {" ".join(k): v
                                    for k, v in gattrs.items()}},
              "cli": {"stream_GBps": cli_bw / 1e9, "runs": cli_results,
                      "checks": cli_checked, "probes": probes,
                      "k11_rates_events": rates, **cli_report}}
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
