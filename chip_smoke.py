#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against their plain versions.

Run from the repository root:  python3 chip_smoke.py

Phases, in order (but for 20-27, as the note after 19 says); the first failure ends the run with
a non-zero exit code:
  1. environment: torch, CUDA, the card and its power limit (no CUDA device: exit 1);
  2. build: compile every kernel source under latticeqcd_torch/csrc with nvcc, in parallel;
  3. kernels against their plain PyTorch versions on the card, at 4^4, 4x8x2x4, 2x4x2x6
     (X/2 = 1), 4x2x6x2 (extent-2 y and T), 8x6x10x4 and 16^3x32, in complex64 (bar 1e-5) and
     complex128 (bar 1e-12): wilson_hop_packed for both target parities and the backward of
     WilsonHopPacked through it; wilson_hop's full mode and its packed mode (the yardstick);
     and at r = 0.5 wilson_hop_packed's r mode at 16^3x32 in both types: both parities with a
     chain axis of 2 (one launch), the backward, and the halo mode on each 16^3x16 block of a
     t cut (faces cut from the global field), against the plain versions at r = 0.5;
  4. timing at 16^3x32 (CUDA graphs between CUDA events): kernel and plain (the plain
     version over fewer calls), each beside its bound, the least time the card could take
     (bytes over 3.35 TB/s, operations over the peak);
     the kernel cold (three input sets taken in turn, beyond the L2) and warm (one set);
     wilson_hop_packed and wilson_hop's packed mode also in turns (site, brick, brick, site);
     a row for the r mode at r = 0.5 (the same bytes, 2688 flop per target site);
  5. one 4^4 complex128 Wilson HMC trajectory through the kernel and through the plain path on
     the card (the wrappers' plain versions swapped in for this run only) from the same injected
     draws, and an MD reversibility check; then at r = 0.5 (the kernels' r mode) a Wilson
     trajectory, a clover one (csw 1.0) and a domain-wall one (L5 2), kernel path against
     plain path (dH 1e-9, links 1e-10);
  6. the Wilson main path: run_lqcd_params at 16^3x32, SU(3), 2-flavour Wilson HMC, complex64,
     2 trajectories, with the Wilson kernels' launch counts set to 0 just before and read just
     after: wilson_hop_packed must have run, wilson_hop's packed mode never; then the same
     action at r = 0.5 from a TOML, 1 trajectory with a Wilson spectrum at r = 0.5: dH finite,
     every CG verified, both Wilson kernels launched in their r mode and never at r = 1;
  7. staggered_w against its plain version at 4^4, 4x8x2x2, 2x4x2x6, 4x2x6x2 (extent-2 y and
     T), 8x6x10x4 (extents the fused W's tile does not divide), 12^3x8 and 16^3x32 in both
     types at mass 0.5 on hot links, and on phase 16's inputs (the links of pbp56_ckpt.npz
     with the boundary phases, m = 0.025): the packed hop for both target parities, the
     two-launch W of the paths, the backward of StaggeredHopPacked, and the one-launch W
     (staggered_w_fused, thread-block clusters);
  8. timing of staggered_w (W and one hop) and of staggered_w_fused at 16^3x32, as phase 4,
     beside the W's bound; the one-launch and the two-launch W also in turns (fused,
     two-launch, two-launch, fused);
  9. 4^4 complex128 staggered trajectories (Nf=2 RHMC, Nf=4 HMC), kernel path against plain
     path as in phase 5, and Nf=2 MD reversibility;
 10. the staggered main path: run_lqcd_params at 16^3x32, SU(3), staggered mass 0.5,
     complex64, 2 trajectories at Nf=4 and 2 at Nf=2, with staggered_w's launch counts set to
     0 just before and read just after (the W's launches printed per trajectory;
     staggered_w_fused must stay at 0);
 11. wilson_window against its plain version at 4^4, 4x8x2x4, 4x8x2x2 (T=2), 3x5x2x6 (odd
     extents), 2x1x9x3 (extent 1), 5x6x9x30 and 16^3x32 in both types, forward and the
     backward for psi and U, and against wilson_hop's full mode; and its r mode at r = 0.5 at
     16^3x32 in both types, forward, backward and the halo mode on each 16^3x16 block of a t
     cut, against the plain versions at r = 0.5;
 12. timing of wilson_window at 16^3x32, as phase 4, and in turns with wilson_hop's full D
     (window, full, full, window), which it must beat; a row for the r mode at r = 0.5 (the same
     bytes, 2736 flop per site);
 13. the fermionic measurements at 4^4 complex128 (Wilson pion correlator, Wilson and
     staggered condensates per noise from the same Z4 draws, Wilson low spectrum from the same
     start vector, a CGNE pion correlator on 3x5x2x6), kernel path against plain path;
 14. the measurement path: run_lqcd_params at 16^3x32, the phase-6 Wilson action, complex64,
     1 trajectory, with the pion correlator, the Wilson and staggered condensates (Nr=10) and
     the Wilson Dirac spectrum at itrj 0 and 1; every kernel's launch count set to 0 just
     before and read just after (wilson_hop's packed mode and staggered_w_fused must stay at
     0), each method's
     seconds, iterations and launches printed;
 15. configurations on disk at 16^3x32 complex64, the phase-6 Wilson action from a cold start:
     run_lqcd_params for 2 trajectories saving ILDG, and again saving NPZ; every saved file
     (and checkpoint.npz) loads back bit for bit equal to the links the run held; BridgeText
     round-trips through io on the same links, and JLD too if h5py imports (else its clear
     error is checked); a Fileloading run over the ILDG files measures Plaquette (bit for bit
     the HMC run's lines) and a Wilson Chiral_condensate; 4 trajectories straight against the
     NPZ run resumed from its checkpoint for 2 more, bit for bit (links, dH, the saved file
     and the Plaquette series the resumed run appends to); save and load seconds per
     format and the file sizes printed; wilson_hop_packed's launches counted per run;
 16. the pbp anchor, short: an NPZ file start from PERF_CAPTURE/pbp56_ckpt.npz (the JAX chain's
     thermalised beta = 5.6 state, 12^3x8), Nf=4 staggered at m = 0.025 with 35 MD steps of
     1/35, complex64, 2 trajectories and Chiral_condensate (Nr=2) at itrj 0 and 2; it fails if
     a solve hits its limit, dH is not finite, a plaquette lies outside 0.575-0.589 or a pbp
     outside 0.1239-0.1467; seconds per trajectory, CG iterations per solve and staggered_w
     launches printed;
 17. the quenched pieces at 4^4 complex128, the card against the CPU (bar 1e-12): one
     overrelaxation sweep for NC = 2, 3, 4 (the total action also conserved to 1e-8 relative),
     one heatbath sweep from the same uniforms drawn on the host with numpy for NC = 2, 3,
     5 gradient-flow steps of 0.02, the topological charge (plaquette, clover, improved), the
     energy density and the Wilson loops W(R, T), R, T <= 4;
 18. the quenched path: run_lqcd_params at 16^3x32, SU(3), beta = 6.0, Heatbath with 3
     overrelaxations, complex64, cold start, 4 steps; Plaquette, Polyakov_loop,
     Topological_charge, Energy_density, Wilson_loop (Rmax = Tmax = 4) and a Wilson
     Pion_correlator at kappa = 0.12 at itrj 0, 2 and 4; 20 flow steps of 0.02 after each step
     with Energy_density and Topological_charge every 5; wilson_hop_packed's launch count set to
     0 just before and read just after; it fails if a plaquette after a step leaves 0.55-1.0,
     the unitarity defect after the run exceeds 1e-4, a Q or E is not finite, the flowed E does
     not move toward its unit-link value 1 from one measured flow step to the next, a pion CG
     reaches its limit or wilson_hop_packed did not run; seconds per heatbath and per
     overrelaxation sweep, per measurement method and per flow step printed;
 19. the 12^4 plaquette anchor, short: validation_plaq's chain at beta = 6.0 (complex64, cold
     start, heatbath without overrelaxation) for 60 sweeps; the mean plaquette of sweeps 31-60
     must lie within 0.593745 +- 0.0025 (the JAX chain's 12^4 value); seconds per sweep printed.
     Then the shared group of phases 31-35 (two gloo ranks on the card, python -c
     subprocesses of this script) starts and runs every run of theirs beside phases 20, 22,
     24 and 26, whose checks are agreements, not times; phases 21, 23, 25 and 27 run after
     those four, and phase 31 waits for the group.
 20. the improved-action pieces at 4^4 complex128: the generic staples and force of the Iwasaki,
     chair, polyakov_t and a coupling_loops action, a 2-layer stout smear, card against CPU (bar
     1e-12); the generic plaquette staple against the fused one; the stout-smeared Wilson and
     staggered (Nf = 4, 2) forces kernel path against plain path (1e-10 relative); one
     trajectory each of scenario 7's action (Wilson, beta 5.7, kappa 0.141139, QPQ with
     Sexton-Weingarten nsw 10, 5 of its 20 steps of 0.05), phase 21's action and staggered Nf = 2 RHMC on
     one stout layer with QPQ-SW (4 steps), kernel path against plain path (dH 1e-9, links
     1e-10); MD reversibility of phase 21's action over 2 steps (1e-8); a plaquette + rectangle
     action's overrelaxation
     (the action conserved to 1e-8 relative) and heatbath sweep from host uniforms for NC = 2,
     3 on 3^4, card against CPU;
 21. the improved-action path: run_lqcd_params at 16^3x32, SU(3), complex64, hot start, 2
     trajectories of the Iwasaki action at beta_I = 2.6 with 2-flavour Wilson fermions at kappa
     0.12 on 2 plaquette stout layers of rho 0.1, Omelyan with Sexton-Weingarten nsw 4, 5
     steps of 0.04; the Wilson kernels' launch counts set to 0 just before and read just after
     (wilson_hop_packed must have run, wilson_hop's packed mode never); it fails if dH is not
     finite, a solve reaches MaxCGstep or fails its verification, the unitarity defect after the
     run exceeds 1e-4 or a plaquette leaves (0, 1); seconds per trajectory, CG iterations per
     solve, launches per trajectory and torch.cuda.max_memory_allocated printed, and, on the
     run's links, one Iwasaki force, one Wilson force and one stout forward + backward timed;
 22. the domain-wall pieces at 4x4x2x2, L5 = 4, m = 0.3, M = -1.8: D, D^dag, D^dag D (through
     wilson_window, 2 L5 launches each D^dag D) also on 3x4x2x2 (odd extent), Shat with and
     without dag and Shat^dag Shat (wilson_hop_packed, 2 L5 launches per Shat), card against
     CPU in complex128 (bar 1e-12) and complex64 (1e-5 relative); the action, the force
     with and without one stout layer, the effective propagator, the condensate from injected
     Z4 draws and the spectrum from an injected start, card against CPU (1e-10 relative,
     solves to 1e-24); NC = 2 raises on the card at r = 1 and 0.7; one trajectory of 2 MD steps
     kernel path against plain path (dH 1e-9, links 1e-10) and MD reversibility (1e-8);
 23. the domain-wall path: run_lqcd_params at 16^3x32, SU(3), beta = 6.0, two-flavour Shamir
     domain wall at M = -1.8, L5 = 16, m = 0.04 (Pauli-Villars partner at m = 1), QPQ 10 steps
     of 0.02, complex64, hot start, 1 trajectory, with the pion correlator, the condensate
     (Nr = 10) and the spectrum at itrj 0; every kernel's launch count set to 0 just
     before and read just after; it fails if dH is not finite, a solve (the
     pseudofermion's too) reaches MaxCGstep or misses its target, the unitarity defect exceeds
     1e-4, a plaquette leaves (0, 1), a pion correlator value is not positive, the Ritz values
     are not ascending and positive, wilson_hop_packed or wilson_window did not run, or
     wilson_hop's packed mode did; seconds per trajectory and per method, CG iterations,
     launches per trajectory and torch.cuda.max_memory_allocated printed, and, on the run's
     links, one Shat^dag Shat (which must launch wilson_hop_packed 4 L5 times) beside its two
     bounds and one domain-wall force timed;
 24. the self-learning updaters at 4^4 complex128, each step on the card through the kernels,
     on the card through their plain versions and on the CPU from the same host draws (dH 1e-9,
     links 1e-10, beta_eff 1e-7 relative, its difference printed): quenched SLHMC learning
     beta = 5.7 from beta_eff = 3.0 (5 trajectories), one SLHMC trajectory with Wilson fermions
     at kappa 0.141139 and one with staggered Nf = 4 at m = 1.0, one SLMC step of the Iwasaki
     action on a plaquette + rectangle basis (on 3^4), the dense fermion
     determinant of Wilson (dim 3072, 3072 wilson_window launches) and staggered fermions (W_e
     of dim 384, 384 staggered_w launches; relative 1e-12) card against CPU and kernel against
     plain, one IntegratedHMC trajectory and one IntegratedHB step with the Wilson determinant
     at 4x4x2x2 (kernel path against plain path);
 25. the self-learning path: run_lqcd_params at 16^3x32, complex64, hot start, QPQ 10 steps of
     0.02, 4 steps each of SLHMC with two-flavour Wilson fermions (beta 6.0, kappa 0.141139) on a
     plaquette + rectangle basis from beta_eff [6, 0] and of quenched SLMC (beta 6.0 from
     beta_eff 5.5), then IntegratedHMC with Wilson and IntegratedHB with staggered Nf = 4
     fermions at 4^4 (the dense determinant's cap), 2 steps each; every kernel's launch count set
     to 0 just before each run and read just after; it fails if a dH is not finite, a solve
     reaches MaxCGstep, wilson_hop_packed did not run under SLHMC or ran in its gluonic MD,
     SLMC did not learn beta or a log det did not launch its kernel once per column; seconds
     and beta_eff per step, acceptance, CG iterations, launches, one effective force, one
     coefficient sweep beside a plain heatbath sweep and torch.cuda.max_memory_allocated
     printed;
 26. clover and Hasenbusch at 4^4, 4x2x4x2 (extent-2 y and T) and 4^3x8 in complex128, kappa
     0.13625, csw 1.90952: the clover term card against CPU; D and D^dag with the clover term
     (wilson_window alone) and the clover Schur Dhat with and without dag (wilson_hop_packed
     alone) kernel against plain and card against CPU (bar 1e-12), with the packed blocks A_ee
     and A_oo^-1; the clover force (1e-10 relative); one trajectory each of clover HMC (QPQ,
     wilson_window alone), Hasenbusch + Sexton-Weingarten nsw 2 at csw 0 (wilson_hop_packed
     alone) and at csw 1.90952 (wilson_window alone), kernel path against plain path (dH 1e-9,
     links 1e-10); the clover pion correlator (the Schur solve: wilson_hop_packed alone), pbp
     per noise from the same Z4 draws and low spectrum from the same start vector (wilson_window
     alone), kernel path against plain path (1e-9 relative);
 27. the clover path: run_lqcd_params at 16^3x32, SU(3), complex64, hot start, the Wilson
     plaquette action at beta 5.3 with two-flavour clover Wilson fermions at kappa 0.13625, csw
     1.90952 (the CLS Nf = 2 point), QPQ 10 steps of 0.02: 2 trajectories with the clover pion
     correlator, condensate (Nr = 10) and spectrum at itrj 0 and 2, then 2 trajectories with
     Hasenbusch mass preconditioning (mu 0.5) and Sexton-Weingarten nsw 2; every kernel's
     launch count set to 0 just before each run and read just after; it fails if dH is not
     finite, a solve (the Hasenbusch pseudofermion's too) reaches MaxCGstep or misses its
     target, a trajectory launches wilson_hop_packed or no wilson_window, a measurement does not
     launch its kernel, the unitarity defect exceeds 1e-4, a plaquette leaves (0, 1), a pion
     correlator value is not positive or the Ritz values are not ascending and positive;
     seconds and launches per trajectory and per method, CG iterations per solve and
     torch.cuda.max_memory_allocated printed, and, on the run's links, the clover term's build
     (forward, and forward + backward) and the 12x12 site product (full volume and packed)
     beside their bounds, the range of A_oo's eigenvalues, one heavy and one light force.
 28. the chain axis: wilson_hop_packed and staggered_w (hop and W) with 1, 3 and 8 chains (no
     two chains' links equal) on phase 3's and phase 7's lattices, in complex64 (bar 1e-5) and
     complex128 (1e-12), both target parities, forward (one launch for all chains) and the
     backward for the links and the field, against the plain per-chain versions; wilson_window
     (its chains entry points) with 1, 3 and 8 chains on 4^4, 3x5x2x6, 8x6x10x4 and 16^3x32 at
     r = 1 and r = 0.5, forward (one launch, counted in chain_launches) and the backward for
     the links and the field; each kernel also at the chain counts of phase 29's paths; the
     window's chain form timed: at 16^3x32 a chain axis of one (the chains entry point)
     beside none (the one-chain entry point) in turns, and 16 chains at 8^4 in one launch
     beside the same lattices as 16 one-chain launches, against the bound; step_batched
     of 4 chains against 4 single-chain steps from the same draws at 4^4 complex128, quenched,
     Wilson and staggered Nf = 4 and Nf = 2 (dH 1e-10, links 1e-12, the same accept); mixed MD in
     complex128 against plain complex128 (dH 1e-9, links 1e-12), and a mixed complex64 Wilson
     trajectory through the kernels against the plain path (dH 5e-4, the same accept);
 29. the paths of mixed MD and batched chains: phase 6's run with MDprecision = "mixed" beside
     the plain one (seconds per trajectory; wilson_hop_packed's launches counted from 0 over the
     mixed run; it fails if the kernel did not run, or wilson_hop's packed mode or
     staggered_w_fused did), one 16^3x32 trajectory plain and mixed in turns, the link update in
     complex64 and complex128 timed; the tracking check at 16^3x32 (5 quenched MD steps:
     mixed complex64 must land at least 5x closer to complex128 than plain complex64); and
     step_batched of the reference's 4^4 workload (bench.py tier2's action, complex64) as 64
     chains and of staggered Nf = 4 (beta 5.7, m 0.5) at 8^4 as 16 chains, 2 batched
     trajectories each, every kernel's launch count set to 0 just before and read just after,
     beside 4 single-chain steps: seconds per trajectory, configurations per second, launches
     per trajectory, CG iterations and peak memory printed; it fails on a non-finite dH, a solve
     at its limit or a kernel of the path not launched. Then the Wilson family: (a) step_batched
     of 2 chains against 2 single-chain steps at 4^4 complex128 (solves at eps 1e-24; dH 1e-10,
     links 1e-12, the same accept) for clover, Hasenbusch + SW at csw 0 and at phase 27's
     clover point, domain wall (L5 4), stout Wilson, Wilson at r = 0.5 and on 3x4x4x4, each
     failing if its kernel (the window's chain form or the packed hop) did not launch; (b)
     phase 27's clover Hasenbusch + SW at 8^4 and phase 23's domain wall at 4^4 as 16
     complex64 chains, 2 batched trajectories each beside 4 single-chain steps, as above.
 30. the front end on the card: (a) phase 6's action written as a legacy .jl file and run
     through latticeqcd_torch.run_LQCD with no device argument (complex64): its TOML's
     Params must equal phase 6's in every field but the log and measurement paths, its final
     plaquette, dH and CG iterations phase 6's bit for bit (phase 6's hot start rejects both
     trajectories), wilson_hop_packed must have run (wilson_hop's packed
     mode never) and the phase timings report must show 2 update calls; (b) bicgstab on
     WilsonDirac(kappa=0.12).apply at 16^3x32 on hot links in complex64 and complex128 (the
     latter also from the complex64 solution as x0): |D x - b|^2 recomputed on the card
     within the solver's target (in complex64 within the attainable 3e-11 |b|^2),
     wilson_window launched twice per iteration (once more with x0); iterations and seconds
     printed; at 4^4 complex128 the card's solve against the CPU's from the same inputs
     (the same iterations, x to 1e-10 relative); (c) python -m latticeqcd_torch.run with
     --profile, one 8^4 Wilson trajectory in complex64: it must exit 0 and its trace hold
     device events of wilson_hop_packed's kernel; the trace's size printed; (d) python -m
     latticeqcd_torch.demo 5 must exit 0 with 5 sweep lines; (c) and (d) run side by side.
 31. the process grid (parallel/mesh.py): (a) in one process, 16^3x32 cut in two along each
     axis in turn, each block's face buffers built from the global field: wilson_hop_packed's
     halo mode (one launch per call) on each block, both parities, complex64 (bar 1e-5) and
     complex128 (1e-12), against the block of the global kernel's output and against the plain
     halo hop, and its backward (d psi through the halo mode, d u_t and d u_s) against the
     global autograd's block; whether the match is bitwise; the halo mode timed on a block
     beside the kernel without it on the same block and on the whole lattice, and the bytes
     of a face message; the global draws timed against the block's own; (b) two gloo ranks on
     the one card, grid (1, 1, 1, 2), started as python -m latticeqcd_torch.multirun
     subprocesses under a timeout: a 16^3x32 complex128 Wilson trajectory against the same in
     one process (in this one; dH 1e-8, links 1e-10, the ranks' dH bitwise equal), then phase
     6's action in complex64 for 1 trajectory with phase 32's three fermionic measurements
     (its Params phase 6's but for the paths, Nsteps and the methods): dH
     finite and bitwise equal on both ranks, every verified CG residual at or below its target,
     plaquette in (0, 1), halo-mode launches on each rank and no hop without it, the saved
     configuration the gathered blocks bit for bit, seconds per trajectory beside phase 6's;
     (c) the same on nccl when the machine has two or more cards (else it says so); (d) one
     group of two ranks (python -c subprocesses of this script under a timeout) started here
     runs every run of phases 31-34 on the grid, once per backend; this phase's is one
     16^3x32 complex128 Wilson trajectory at r = 0.5 (the packed hop's r mode in its halo
     mode), against the same on one card (dH 1e-8, links 1e-10).
 32. the process grid for staggered, clover and the fermionic measurements: (a) in one process,
     16^3x32 cut in two along each axis in turn: staggered_w's halo mode (the hop onto both
     parities, and the grid W's axpy launch on the faces of d1) and wilson_window's halo mode
     (the full D) on each block, complex64 (bar 1e-5) and complex128 (1e-12), one launch per
     call, against the block of the global kernel's output and the plain halo versions,
     whether the match is bitwise; the t cut's block timed in the halo mode beside mask 0 on
     the same shape, and the bytes of the face messages; (b) phase 31's group of two gloo ranks
     on the one card (python -c subprocesses of this script) runs through
     run_lqcd_params(grid=...) one 16^3x32 complex128 trajectory (2 MD steps of 0.005) each of
     staggered Nf = 4, staggered Nf = 2 RHMC and clover HMC, then this process runs each on one
     card (dH 1e-8, links 1e-10, the ranks' dH, decisions and plaquettes bitwise equal);
     phase 31's complex64 run carries Chiral_condensate (staggered), Pion_correlator (clover)
     and Dirac_spectrum (Wilson), their numbers bitwise the same on both ranks, finite, the
     correlator positive and the Ritz values ascending and positive (checked there); in every
     run no launch of staggered_w, wilson_window or wilson_hop_packed outside a halo mode,
     each run's halo kernel launched, every solve at or below its target; seconds per
     trajectory on the grid beside one card; (c) the same on nccl with two or more cards.
 33. the process grid for Hasenbusch, domain wall and the heatbath: (b) phase 31's group of
     two gloo ranks on the one card runs through run_lqcd_params(grid=...), at 16^3x32 from a
     hot start: one complex128
     trajectory (2 MD steps of 0.005) each of domain-wall HMC (phase 23's beta, M and m at
     L5 = 4), clover Hasenbusch + SW at phase 27's point and Hasenbusch at csw = 0; the three
     domain-wall measurements (at L5 = 2) on the final links; one Shat^dag Shat on them; and
     (c) one heatbath step with 3 overrelaxations (SU(3), beta 6.0, complex64), a sweep and an
     overrelaxation timed; then this process runs each on one card: dH 1e-8 and links 1e-10
     (the ranks' dH, decisions and measurements bitwise equal; the measurements 1e-9 relative
     against one card), the heatbath's links within 1e-12 and its generator state one
     card's; no launch of wilson_hop_packed, wilson_window or staggered_w outside a halo
     mode, each run's halo kernels launched, 4 L5 halo hops per rank per Shat^dag Shat; the
     action parts and seconds per step on the grid beside one card printed; (d) the same on
     nccl with two or more cards.
 34. the process grid for stout, the self-learning updaters and Fileloading: (a) phase 31's
     group of two gloo ranks on the one card runs through run_lqcd_params(grid=...),
     from a hot start: at 16^3x32 one complex128 trajectory (2 MD steps of 0.005) of
     two-flavour Wilson HMC on 2 stout layers (rho 0.1) and one SLHMC step on a plaquette +
     rectangle basis (a reject is allowed: its MD leaves the fermions out), one quenched SLMC
     step (complex64, beta_eff 5.5 refit), Fileloading over two NPZ configurations this phase
     saves (complex128, with the plaquette and the energy density); at 4^4 one IntegratedHB
     step with the staggered dense log det (complex128); then this process runs each on one
     card: dH 1e-8 and links 1e-10 for the HMC and SLHMC trajectories, the same decision,
     links 1e-12 and one card's generator state for the others, beta_eff and the measured
     numbers 1e-12 relative (1e-5 in complex64), the ranks' histories bitwise equal; no
     launch of wilson_hop_packed, wilson_window or staggered_w outside a halo mode, each run's
     halo kernel launched; seconds per step on the grid beside one card and the launches
     printed; (b) the same on nccl with two or more cards.
 35. batched chains on the process grid (HMC.step_batched): (a) in one process, 16^3x32 cut
     in two along each axis in turn, 4 chains (no two chains' links equal), complex64 (bar
     1e-5) and complex128 (1e-12): the chain-halo modes of wilson_hop_packed (both parities,
     and its backward: d psi through the chain-halo mode, d u_t and d u_s against the global
     autograd's block), staggered_w (both parities and the grid W's axpy launch) and
     wilson_window, one launch per call, against the plain halo versions per chain and bit
     for bit against the one-chain halo launch of each chain; each timed on the t cut's
     16^3x16 block for 1, 4 and 16 chains in one launch against as many one-chain halo
     launches (cold, three input sets), beside n times the one-chain halo mode's bytes;
     then phase 31's group of two gloo ranks on the one card (its runs added to the
     group's) runs (b) bench.py tier2's 4^4 action (beta 6.0, kappa 0.141139, dtau 0.1, 10
     MD steps) as 64 complex64 chains split over the ranks, 32 each, two trajectories (the
     first from draws with the uniform 0, every chain accepted; the second from the
     generators): per chain dH 5e-4 and links 1e-5 against one process's step_batched over
     the 64 (whether bitwise is printed), no message and no collective in either rank's
     steps, configurations/s beside one process's and phase 29's; (c) 4 complex64 chains of
     phase 6's Wilson action on 16^3x32 cut along t, one trajectory of 2 MD steps: dH finite
     and bit for bit on both ranks, every verified solve at its target, every packed hop
     in the chain-halo mode, a hop on the final links one launch and one batch of one
     chain's 4 messages holding 4 chains' faces; seconds per trajectory; (d) the same grid
     over 8^4, 2 complex128 chains of 2 MD steps of 0.005, each of Wilson at r = 1 and r =
     0.5, clover Hasenbusch + SW (phase 27's point), domain wall (L5 4), stout Wilson,
     staggered Nf = 4 and mixed-MD Wilson against one card's step_batched (dH 1e-8, links
     1e-10, the same decisions, the ranks' dH bitwise equal), each launching its
     chain-halo kernel and no kernel outside a halo mode; (e) 4 Wilson chains on 2 chain
     groups x (1, 1, 1, 2) over 8^4 on nccl when the machine has four or more cards (else it
     says so), against one process.
Then it prints one JSON line describing each kernel (its launches summed over the main paths
that run it), the card's name and power limit as nvidia-smi gives them, and, as its last
line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

BARS = {"complex64": 1e-5, "complex128": 1e-12}
# wilson_hop_packed: its brick (1 x 2 rows with t whole up to 32 sites at complex64, 2 x 1 rows
# with t segments of at most 16 at complex128) wraps onto itself in x (X/2 = 1), y, z or t
# (extent 2), and the complex128 segments cut T = 32 and T = 6 unevenly
LATTICES = [(4, 4, 4, 4), (4, 8, 2, 4), (2, 4, 2, 6), (4, 2, 6, 2), (8, 6, 10, 4), (16, 16, 16, 32)]
# wilson_window: its tile (1 x 2 rows with t whole up to 32 sites at complex64, one row over t
# segments of at most 16 at complex128, marching along x over chunks) wraps onto itself in y
# (extent 1) or z (extent 2), does not divide z (extent 9) or x into equal chunks, and
# its complex128 segments cut T = 30 and T = 32
WINDOW_LATTICES = [(4, 4, 4, 4), (4, 8, 2, 4), (4, 8, 2, 2), (3, 5, 2, 6), (2, 1, 9, 3),
                   (5, 6, 9, 30), (16, 16, 16, 32)]
# staggered_w_fused: its 8 x 4 x 4-row cluster tile (2 x 2 x 2 rows a block) wraps onto itself
# or does not divide x', y or z in all but the last, and cuts T = 32 at complex128; 12^3x8 is
# the pbp anchor's lattice (phase 16)
STAGGERED_LATTICES = [(4, 4, 4, 4), (4, 8, 2, 2), (2, 4, 2, 6), (4, 2, 6, 2), (8, 6, 10, 4),
                      (12, 12, 12, 8), (16, 16, 16, 32)]
MAIN = (16, 16, 16, 32)
KAPPA = 0.141139
MASS = 0.5
# the Wilson r of the kernels' r mode checks (wilson_hop_packed and wilson_window at r != 1)
R_MODE = 0.5
# operations per site of the r mode (three lanes a site, each of the 8 neighbours: 4 colour
# products of 3 complex multiply-adds and the 4 x 4 spin matrix; the window also -kappa)
R_FLOP_PACKED, R_FLOP_WINDOW = 2688, 2736

# The H100 SXM's published rates (NVIDIA data sheet): HBM3 bandwidth, and the peak outside
# the tensor cores for the real type of each complex type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"complex64": 67e12, "complex128": 34e12}

STATE = {"err": {"wilson_hop_packed": 0.0, "wilson_hop": 0.0, "staggered_w": 0.0,
                 "staggered_w_fused": 0.0, "wilson_window": 0.0, "wilson_hop_packed_r": 0.0,
                 "wilson_window_r": 0.0, "wilson_window_chains": 0.0,
                 "wilson_hop_packed_chain_halo": 0.0, "staggered_w_chain_halo": 0.0,
                 "wilson_window_chain_halo": 0.0}, "checks": 0,
         "timing": {}, "launches": {}}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check(label: str, err: float, bar: float, kernel: str = None):
    """Fail unless err < bar; a kernel-vs-plain check also counts toward that kernel's max error."""
    if kernel is not None:
        STATE["err"][kernel] = max(STATE["err"][kernel], err)
    STATE["checks"] += 1
    ok = math.isfinite(err) and err < bar
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: max|diff| = {err:.3e} (bar {bar:.0e})", flush=True)
    if not ok:
        fail(f"{label} disagrees with its plain version: {err} >= {bar}")


def maxdiff(a, b) -> float:
    return float((a - b).abs().max())


# ------------------------------------------------------------------ phases


def phase_env(torch):
    print("== 1. environment", flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(f"device 0: {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    STATE["smi"] = nvidia_smi()
    print(f"nvidia-smi: {STATE['smi']}", flush=True)


def phase_build(torch):
    print("== 2. build", flush=True)
    from latticeqcd_torch import _nvcc

    names = sorted(p[:-3] for p in os.listdir(_nvcc.CSRC) if p.endswith(".cu"))
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = list(pool.map(_nvcc.build, names))
    print(f"built {', '.join(names)} in {time.time() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas: {line.strip()}")


def _fields(torch, lat, dtype, seed):
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases, gaussian_spinor

    dev = torch.device("cuda")
    u = apply_boundary_phases(fields.hot_start(lat, 3, seed=seed, dtype=dtype, device=dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    psi = gaussian_spinor(lat, 3, dtype=dtype, device=dev, generator=g)
    return u, psi, g


def phase_kernels(torch):
    print("== 3. wilson_hop_packed and wilson_hop against their plain version", flush=True)
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import gaussian_spinor

    for lat in LATTICES:
        for dtype in (torch.complex64, torch.complex128):
            bar = BARS[str(dtype).split(".")[1]]
            tag = f"{'x'.join(map(str, lat))} {str(dtype).split('.')[1]}"
            u, psi, g = _fields(torch, lat, dtype, seed=sum(lat))
            out = wk.wilson_dslash(u, psi, KAPPA)
            torch.cuda.synchronize()
            check(f"full D {tag}", maxdiff(out, wk.dslash_reference(u, psi, KAPPA)), bar,
                  "wilson_hop")

            u_e, u_o = eo_pack.pack_links(u, lat)
            half = (lat[0] // 2,) + lat[1:]
            x = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
            cot = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                before = wk.launches
                got = wk.wilson_hop_packed(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                if wk.launches != before + 1:
                    fail("wilson_hop_packed did not launch")
                ref = wk.hop_packed_reference(u_t, u_s, x, parity)
                check(f"packed hop p={parity} {tag}", maxdiff(got, ref), bar, "wilson_hop_packed")
                site = wk.hop_packed_site(u_t, u_s, x, parity)
                torch.cuda.synchronize()
                check(f"site kernel packed hop p={parity} {tag}", maxdiff(site, ref), bar,
                      "wilson_hop")

                leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
                grads_k = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity), leaves, cot)
                grads_p = torch.autograd.grad(wk.hop_packed_reference(*leaves, parity), leaves, cot)
                torch.cuda.synchronize()
                for name, a, b in zip(("u_t", "u_s", "psi"), grads_k, grads_p):
                    check(f"packed backward d{name} p={parity} {tag}", maxdiff(a, b), bar,
                          "wilson_hop_packed")
    _r_mode_packed(torch)


def _counted(torch, fn, counters, label):
    """fn(), synchronised, failing unless each (module, attribute) of counters rose by one."""
    before = [getattr(m, a) for m, a in counters]
    out = fn()
    torch.cuda.synchronize()
    if [getattr(m, a) for m, a in counters] != [b + 1 for b in before]:
        fail(f"{label} did not launch its kernel once ({', '.join(a for _, a in counters)})")
    return out


def _t_cut_blocks(torch, fields, leads):
    """The two blocks of a t cut of 16^3x32 (grid (1, 1, 1, 2)): for each rank, its grid and
    each field's block (lattice axes from its lead), contiguous."""
    from latticeqcd_torch.parallel import mesh

    for rank in (0, 1):
        grid = mesh.ProcessGrid((1, 1, 1, 2), MAIN, rank=rank, device=torch.device("cuda"))
        yield grid, [grid.block(f, lead).contiguous() for f, lead in zip(fields, leads)]


def _r_mode_packed(torch):
    """Phase 3 at r = 0.5: wilson_hop_packed's r mode at 16^3x32 in both types and both
    parities, with a chain axis of 2 (one launch, each chain against its plain hop), its
    backward on one chain, and its halo mode on each 16^3x16 block of a t cut, the faces cut
    from the global field, against the block of the global plain hop and the plain halo hop."""
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import gaussian_spinor

    lat, r = MAIN, R_MODE
    half = (lat[0] // 2,) + lat[1:]
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        bar = BARS[name]
        tag = f"r = {r} {'x'.join(map(str, lat))} {name}"
        u, _, g = _fields(torch, lat, dtype, seed=51)
        packed = [eo_pack.pack_links(v, lat) for v in (u, _fields(torch, lat, dtype, seed=52)[0])]
        x = gaussian_spinor((2,) + half, 3, dtype=dtype, device=u.device, generator=g)
        cot = gaussian_spinor(half, 3, dtype=dtype, device=u.device, generator=g)
        for parity in (0, 1):
            u_t = torch.stack([p[parity] for p in packed])
            u_s = torch.stack([p[1 - parity] for p in packed])
            got = _counted(torch, lambda: wk.wilson_hop_packed(u_t, u_s, x, parity, r),
                           [(wk, "launches"), (wk, "r_launches")], "the r mode's chain axis")
            for c in (0, 1):
                ref = wk.hop_packed_reference(u_t[c], u_s[c], x[c], parity, r)
                check(f"packed hop chain {c} of 2 p={parity} {tag}", maxdiff(got[c], ref), bar,
                      "wilson_hop_packed_r")
            leaves = [t.detach().clone().requires_grad_(True) for t in (u_t[0], u_s[0], x[0])]
            grads_k = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity, r), leaves, cot)
            grads_p = torch.autograd.grad(wk.hop_packed_reference(*leaves, parity, r), leaves, cot)
            torch.cuda.synchronize()
            for gname, a, b in zip(("u_t", "u_s", "psi"), grads_k, grads_p):
                check(f"packed backward d{gname} p={parity} {tag}", maxdiff(a, b), bar,
                      "wilson_hop_packed_r")
            ref = wk.hop_packed_reference(u_t[0], u_s[0], x[0], parity, r)
            for grid, blocks in _t_cut_blocks(torch, (u_t[0], u_s[0], x[0]), (1, 1, 0)):
                faces, links = _block_faces(grid, x[0], u_s[0])
                got = _counted(torch, lambda: wk.hop_packed_halo(*blocks, parity, faces, links, r),
                               [(wk, "halo_launches"), (wk, "r_halo_launches")],
                               "the r mode's halo mode")
                btag = f"t cut block {grid.rank} p={parity} {tag}"
                check(f"halo hop {btag} vs the global plain hop", maxdiff(got, grid.block(ref)),
                      bar, "wilson_hop_packed_r")
                plain = wk.hop_packed_halo_reference(*blocks, parity, faces, links, r)
                check(f"halo hop {btag} vs plain", maxdiff(got, plain), bar, "wilson_hop_packed_r")


def _r_mode_window(torch):
    """Phase 11 at r = 0.5: wilson_window's r mode at 16^3x32 in both types, forward and the
    backward for psi and U, and its halo mode on each 16^3x16 block of a t cut, the faces
    cut from the global field, against the block of the global plain D and the plain halo D."""
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    lat, r = MAIN, R_MODE
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        bar = BARS[name]
        tag = f"r = {r} {'x'.join(map(str, lat))} {name}"
        u, psi, g = _fields(torch, lat, dtype, seed=53)
        got = _counted(torch, lambda: ww.wilson_window(u, psi, KAPPA, r),
                       [(ww, "launches"), (ww, "r_launches")], "the window's r mode")
        ref = wk.dslash_reference(u, psi, KAPPA, r)
        check(f"window D {tag}", maxdiff(got, ref), bar, "wilson_window_r")
        cot = torch.randn(psi.shape, dtype=dtype, device=psi.device, generator=g)
        leaves = [t.detach().clone().requires_grad_(True) for t in (u, psi)]
        grads_k = torch.autograd.grad(ww.wilson_window(*leaves, KAPPA, r), leaves, cot)
        grads_p = torch.autograd.grad(wk.dslash_reference(*leaves, KAPPA, r), leaves, cot)
        torch.cuda.synchronize()
        for gname, a, b in zip(("u", "psi"), grads_k, grads_p):
            check(f"window backward d{gname} {tag}", maxdiff(a, b), bar, "wilson_window_r")
        for grid, (u_b, psi_b) in _t_cut_blocks(torch, (u, psi), (1, 0)):
            faces, links = _block_faces(grid, psi, u)
            got = _counted(torch, lambda: ww.dslash_halo(u_b, psi_b, KAPPA, faces, links, r),
                           [(ww, "halo_launches"), (ww, "r_halo_launches")],
                           "the window's r mode in its halo mode")
            btag = f"t cut block {grid.rank} {tag}"
            check(f"halo window D {btag} vs the global plain D", maxdiff(got, grid.block(ref)),
                  bar, "wilson_window_r")
            plain = wk.dslash_halo_reference(u_b, psi_b, KAPPA, faces, links, r)
            check(f"halo window D {btag} vs plain", maxdiff(got, plain), bar, "wilson_window_r")


def _events(torch):
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def _time_eager(torch, fn, n=50, warm=5) -> float:
    """Median milliseconds of one eager call, CUDA events around each call:
    what a caller such as the CG loop sees, host overhead included."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        start, end = _events(torch)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _time_device(torch, fn, reps=12, n=20) -> float:
    """Median device milliseconds of one call: `reps` calls captured in a
    CUDA graph, the graph replayed `n` times between CUDA events, so the
    host's launch overhead is not in the number. `fn` may be a list of
    calls on distinct inputs, taken in turn, so that no call finds its
    inputs in the 50 MB L2 cache where the previous one left them."""
    fns = fn if isinstance(fn, list) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = _events(torch)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def _time_case(torch, label, dtype_name, kerns, plain, nbytes, flops):
    """Device and eager times of a kernel and its plain version, beside the bound: the larger
    of the least bytes the function must move over the HBM rate and its operations over the
    peak rate for its type. `kerns` are the kernel's call on three input sets: the cold time
    takes them in turn (113 MB or more, so the inputs come from HBM), the warm time repeats
    the first (its links may stay in L2). The line's time is the cold one. The plain version,
    1-20 ms a call at 16^3x32, is timed over fewer calls (5 replays of 4, 10 eager calls)."""
    t_k, t_w = _time_device(torch, kerns), _time_device(torch, kerns[0])
    t_p = _time_device(torch, plain, reps=4, n=5)
    e_k, e_p = _time_eager(torch, kerns[0]), _time_eager(torch, plain, n=10, warm=2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOP_PER_S[dtype_name] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"  {label:20s} {dtype_name:10s} device: kernel {t_k * 1e3:8.1f} us cold "
          f"({t_w * 1e3:8.1f} us warm)  plain {t_p * 1e3:9.1f} us  bound {bound * 1e3:6.1f} us "
          f"({by}; {nbytes / 1e6:.1f} MB, {nbytes / (t_k * 1e-3) / 1e9:6.1f} GB/s cold, "
          f"{100 * bound / t_k:5.1f}% of bound); eager call: kernel {e_k * 1e3:8.1f} us  plain "
          f"{e_p * 1e3:9.1f} us  [{STATE['smi']}]", flush=True)
    STATE["timing"][(label, dtype_name)] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                                            "bound_by": by}


def phase_timing(torch):
    print("== 4. wilson_hop_packed and wilson_hop timing at 16^3x32", flush=True)
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, gaussian_spinor

    lat = MAIN
    vol = lat[0] * lat[1] * lat[2] * lat[3]
    dirac = WilsonDirac(kappa=KAPPA)
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = []
            for seed in (7, 8, 9):
                u, psi, g = _fields(torch, lat, dtype, seed=seed)
                x = gaussian_spinor((lat[0] // 2,) + lat[1:], 3, dtype=dtype, device=u.device,
                                    generator=g)
                sets.append((u, psi, eo_pack.pack_links(u, lat), x))
            u, psi, (u_e, u_o), x = sets[0]

            def plain_dhat(v):
                d1 = wk.hop_packed_reference(u_o, u_e, v, 1)
                return v - KAPPA ** 2 * wk.hop_packed_reference(u_e, u_o, d1, 0)

            # least bytes at complex64: the full D reads each link and spinor once and writes
            # the output (480 B/site); a packed hop reads the links of both parities (576 B per
            # target site), its source field and writes its output (768 B per target site);
            # the packed D^D^dag is charged four hops and its two axpys (3 x 96 B each)
            cases = {
                "full D": ([lambda s=s: wk.wilson_dslash(s[0], s[1], KAPPA) for s in sets],
                           lambda: wk.dslash_reference(u, psi, KAPPA), 480 * vol, 1320 * vol),
                "packed hop": ([lambda s=s: wk.wilson_hop_packed(*s[2], s[3], 0) for s in sets],
                               lambda: wk.hop_packed_reference(u_e, u_o, x, 0),
                               768 * vol // 2, 1320 * vol // 2),
                "packed hop, site": ([lambda s=s: wk.hop_packed_site(*s[2], s[3], 0) for s in sets],
                                     lambda: wk.hop_packed_reference(u_e, u_o, x, 0),
                                     768 * vol // 2, 1320 * vol // 2),
                "packed DhatDhat^dag": (
                    [lambda s=s: dirac.apply_dhat_ddag(s[2], s[3]) for s in sets],
                    lambda: plain_dhat(wk.gamma5(plain_dhat(wk.gamma5(x)))),
                    (4 * 768 + 6 * 96) * vol // 2, (4 * 1320 + 2 * 48) * vol // 2),
                # the r mode: the same bytes, the spin matrix on four spins of U psi
                f"packed hop r={R_MODE}": (
                    [lambda s=s: wk.wilson_hop_packed(*s[2], s[3], 0, R_MODE) for s in sets],
                    lambda: wk.hop_packed_reference(u_e, u_o, x, 0, R_MODE),
                    768 * vol // 2, R_FLOP_PACKED * vol // 2),
            }
            for case, (kern, plain, nbytes, flops) in cases.items():
                _time_case(torch, case, name, kern, plain, f * nbytes, flops)
            # the redesigned packed hop against wilson_hop's packed mode, cold, in turns
            turns = {"site": [], "brick": []}
            for label in ("site", "brick", "brick", "site"):
                kerns = cases["packed hop" if label == "brick" else "packed hop, site"][0]
                turns[label].append(_time_device(torch, kerns))
            bound = STATE["timing"][("packed hop", name)]["bound_ms"]
            print(f"  packed hop {name} in turns (site, brick, brick, site), cold: brick "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['brick'])} us, site "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['site'])} us, bound "
                  f"{bound * 1e3:.1f} us: brick {100 * bound / statistics.mean(turns['brick']):.1f}%"
                  f", site {100 * bound / statistics.mean(turns['site']):.1f}% of bound "
                  f"[{STATE['smi']}]", flush=True)
            if statistics.mean(turns["brick"]) > statistics.mean(turns["site"]):
                fail(f"wilson_hop_packed is slower than wilson_hop's packed mode at {name}")


def phase_trajectory_agreement(torch):
    print("== 5. 4^4 complex128 trajectory: kernel path against plain path", flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    dtype = torch.complex128
    u = fields.hot_start(lat, 3, seed=11, dtype=dtype, device=dev)
    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10, fermi_action=fa)
    # uniform 0: both trajectories are accepted, so U' compares the evolved links
    drawn = Draws.sample(hmc, u, torch.Generator(device=dev).manual_seed(12))
    draws = Draws(drawn.mom, drawn.xi, 0.0)

    before, site_before = wk.launches, dict(wk.site_launches)
    u_k, st_k = hmc.step(u, draws=draws)
    launched = wk.launches - before
    if wk.site_launches != site_before:
        fail("the kernel-path trajectory launched wilson_hop")
    with mock.patch.object(wk, "_dslash", wk.dslash_reference), \
            mock.patch.object(wk, "_hop_packed", wk.hop_packed_reference):
        u_p, st_p = hmc.step(u, draws=draws)
    if wk.launches != before + launched:
        fail("the plain-path trajectory launched the kernel")
    d_dh = abs(st_k["dH"] - st_p["dH"])
    d_u = maxdiff(u_k, u_p)
    print(f"  kernel dH {st_k['dH']:.12f} accepted {st_k['accepted']} ({launched} launches); "
          f"plain dH {st_p['dH']:.12f} accepted {st_p['accepted']}")
    if launched == 0:
        fail("the kernel path of the trajectory launched no kernel")
    check("trajectory |ddH|", d_dh, 1e-9)
    check("trajectory max|dU|", d_u, 1e-10)
    if st_k["accepted"] != st_p["accepted"]:
        fail("kernel and plain trajectories disagree on accept")

    # reversibility: integrate forward, flip the momenta, integrate back
    h0 = draws.momentum(u)
    _, phi = fa.sample_pseudofermion(u, normals=draws.xi)
    guess = {"x": None}

    def force_f(uu):
        f, guess["x"] = fa.force_with_guess(uu, phi, guess["x"])
        return f

    force_g = lambda uu: ga.force(hmc.action, uu)
    u1, h1 = integrators.leapfrog_qpq(u, h0, force_g, 0.1, 10, force_f)
    guess["x"] = None
    u2, _ = integrators.leapfrog_qpq(u1, -h1, force_g, 0.1, 10, force_f)
    check("MD reversibility max|dU|", maxdiff(u2, u), 1e-8)
    _r_mode_trajectories(torch)


def _r_mode_trajectories(torch):
    """Phase 5 at r = 0.5: 4^4 complex128 trajectories through the kernels' r mode against the
    plain path from the same draws (dH 1e-9, links 1e-10): Wilson and clover at csw 1.0 (4 MD
    steps of 0.1 each) and two-flavour domain wall at L5 = 2 (2 steps); every Wilson kernel
    launch of them in the r mode."""
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import DomainwallFermiAction, WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    u = fields.hot_start((4, 4, 4, 4), 3, seed=13, dtype=torch.complex128, device="cuda")
    act = ga.wilson_gauge_action(3, 6.0)
    runs = [(f"Wilson r = {R_MODE}", WilsonDirac(kappa=KAPPA, r=R_MODE), 4),
            (f"clover r = {R_MODE} (csw 1.0)", WilsonDirac(kappa=CLOVER_KAPPA, r=R_MODE, csw=1.0),
             4),
            (f"domain wall r = {R_MODE} (L5 2)", DomainwallDirac(0.3, DW_M5, 2, r=R_MODE), 2)]
    for label, dirac, steps in runs:
        fa = (DomainwallFermiAction if isinstance(dirac, DomainwallDirac) else WilsonFermiAction)(
            dirac, eps_cg=1e-19)
        hmc = HMC(action=act, dtau=0.1, md_steps=steps, fermi_action=fa)
        at_one = (wk.launches - wk.r_launches, ww.launches - ww.r_launches)
        launched = _trajectory_pair(torch, label, hmc, u, seed=14)
        if (wk.launches - wk.r_launches, ww.launches - ww.r_launches) != at_one:
            fail(f"{label}: a Wilson kernel launched outside its r mode ({launched})")


def phase_main_path(torch):
    print("== 6. Wilson main path: run_lqcd_params, 16^3x32 Wilson HMC, complex64", flush=True)
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system.lqcd import run_lqcd_params

    p = _wilson_path_params()
    # randomseed 3: its hot start has plaquette +1.66e-4, so the (0, 1) check
    # holds even when both trajectories are rejected, as a dH of O(20) from a
    # hot start at this volume and dtau makes likely
    history = []
    torch.cuda.synchronize()
    wk.launches = 0
    wk.site_launches.update(full=0, packed=0)
    plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda", history=history)
    torch.cuda.synchronize()
    launched, site = wk.launches, dict(wk.site_launches)
    STATE["launches"].setdefault("wilson_hop_packed", {})["Wilson main path"] = launched
    # phase 30 runs the same action from a .jl file and compares with these
    STATE["wilson_main"] = {"plaq": plaq, "dH": [rec["dH"] for rec in history],
                            "cg": [sum(c["iterations"] for c in rec["cg"]) for rec in history],
                            "seconds": [rec["seconds"] for rec in history]}
    for rec in history:
        cg_iters = sum(c["iterations"] for c in rec["cg"])
        worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  CG iterations {cg_iters} "
              f"in {len(rec['cg'])} solves  dH {rec['dH']:.6f}  accepted {rec['accepted']}  "
              f"plaquette {rec['plaq']:.8f}  worst verified residual/target {worst:.3g}  "
              f"[{STATE['smi']}]", flush=True)
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if worst > 1.0:
            fail("a CG returned a verified residual above its target")
    print(f"  final plaquette {plaq:.8f}; launches on the main path: wilson_hop_packed {launched}, "
          f"wilson_hop {site}")
    if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"plaquette {plaq} outside (0, 1)")
    if launched == 0:
        fail("the main path launched wilson_hop_packed no time")
    if site["packed"]:
        fail("the main path launched wilson_hop's packed mode")
    _r_mode_main_path(torch)


# phase 6's action at r = 0.5, with a Wilson spectrum at r = 0.5, as a TOML
R_MODE_TOML = """\
["Physical setting"]
L = [16, 16, 16, 32]
NC = 3
beta = 6.0
initial = "hot"
update_method = "HMC"
quench = false
Dirac_operator = "Wilson"
hop = {kappa}
r = {r}
BoundaryCondition = [1, 1, 1, -1]
QPQ = true
dtau = 0.02
MDsteps = 10
Nsteps = 1
eps = 1e-12
MaxCGstep = 3000
randomseed = 3
verboselevel = 2

["Measurement set"]
measurement_basedir = "{d}/meas"
measurement_dir = "r_mode"
measurement_methods = [{{ methodname = "Plaquette", measure_every = 1 }}, \
{{ methodname = "Dirac_spectrum", measure_every = 1, Neig = 4, Nlanczos = 24, \
fermion_parameters = {{ Dirac_operator = "Wilson", hop = {kappa}, r = {r} }} }}]
"""


def _r_mode_main_path(torch):
    """Phase 6 at r = 0.5: the Wilson main path from a TOML with r = 0.5 through
    run_lqcd_params, 16^3x32 complex64, one trajectory and a Wilson spectrum at r = 0.5, the
    Wilson kernels' counts set to 0 just before and read just after: every launch in the r
    mode, both kernels' r modes launched, dH finite, every CG verified."""
    import tempfile

    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import construct_params_from_toml

    history, spectra = [], []
    measure = scheduler.DiracSpectrumMeasurement.measure

    def measured(self, u, itrj, additional_string=""):
        line = measure(self, u, itrj, additional_string)
        spectra.append([float(v) for v in self.value])
        return line

    with tempfile.TemporaryDirectory(prefix="chip_smoke_r_mode_") as tmp:
        toml = os.path.join(tmp, "r_mode.toml")
        with open(toml, "w") as f:
            f.write(R_MODE_TOML.format(kappa=KAPPA, r=R_MODE, d=tmp))
        p = construct_params_from_toml(toml, make_dirs=True)
        if p.r != R_MODE:
            fail(f"the TOML's r = {R_MODE} was read as {p.r}")
        torch.cuda.synchronize()
        _zero_all_counts()
        t0 = time.time()
        with mock.patch.object(scheduler.DiracSpectrumMeasurement, "measure", measured):
            plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                                   history=history)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    counts = _all_counts()
    STATE["launches"].setdefault("wilson_hop_packed_r", {})[f"Wilson r = {R_MODE} path"] = \
        counts["wilson_hop_packed_r"]
    STATE["launches"].setdefault("wilson_window_r", {})[f"Wilson r = {R_MODE} path"] = \
        counts["wilson_window_r"]
    for rec in history:
        worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
        print(f"  r = {R_MODE} trajectory {rec['itrj']}: {rec['seconds']:.3f} s  CG iterations "
              f"{sum(c['iterations'] for c in rec['cg'])} in {len(rec['cg'])} solves  dH "
              f"{rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  worst "
              f"verified residual/target {worst:.3g}  [{STATE['smi']}]", flush=True)
        if not math.isfinite(rec["dH"]):
            fail(f"r = {R_MODE}: non-finite dH {rec['dH']}")
        if worst > 1.0:
            fail(f"r = {R_MODE}: a CG returned a verified residual above its target")
    print(f"  r = {R_MODE} run_lqcd_params {seconds:.3f} s, final plaquette {plaq:.8f}, the "
          f"Wilson spectrum at r = {R_MODE} {spectra}; launches {counts}", flush=True)
    if len(history) != 1 or not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"r = {R_MODE}: {len(history)} trajectories, plaquette {plaq}")
    lam = np.asarray(spectra[-1] if spectra else [])
    if not (lam.size and np.all(lam > 0) and np.all(np.diff(lam) >= 0)):
        fail(f"r = {R_MODE}: the Wilson spectrum {spectra} is not ascending and positive")
    for name in ("wilson_hop_packed", "wilson_window"):
        if counts[f"{name}_r"] == 0:
            fail(f"the r = {R_MODE} path launched {name}'s r mode no time")
        if counts[name] != counts[f"{name}_r"]:
            fail(f"the r = {R_MODE} path launched {name} at r = 1: {counts}")


def _packed_links(torch, lat, dtype, seed):
    from latticeqcd_torch.ops.dirac import eo_pack

    u, _, g = _fields(torch, lat, dtype, seed)
    return eo_pack.pack_links(u, lat), g


def _staggered_checks(torch, sk, u_e, u_o, x, cot, mass, tag, bar):
    """The two-launch W, the one-launch W and the packed hop of both target parities with
    its backward, each against its plain version on the same inputs."""
    ref = sk.staggered_w_reference(u_e, u_o, x, mass)
    got = sk.staggered_w(u_e, u_o, x, mass)
    torch.cuda.synchronize()
    check(f"W {tag}", maxdiff(got, ref), bar, "staggered_w")
    before = sk.fused_launches
    got = sk.staggered_w_fused(u_e, u_o, x, mass)
    torch.cuda.synchronize()
    if sk.fused_launches != before + 1:
        fail("staggered_w_fused did not launch")
    check(f"one-launch W {tag}", maxdiff(got, ref), bar, "staggered_w_fused")
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        got = sk.staggered_hop_packed(u_t, u_s, x, parity)
        torch.cuda.synchronize()
        ref = sk.staggered_hop_packed_reference(u_t, u_s, x, parity)
        check(f"hop p={parity} {tag}", maxdiff(got, ref), bar, "staggered_w")
        leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
        grads_k = torch.autograd.grad(sk.staggered_hop_packed(*leaves, parity), leaves, cot)
        grads_p = torch.autograd.grad(sk.staggered_hop_packed_reference(*leaves, parity),
                                      leaves, cot)
        torch.cuda.synchronize()
        for gname, a, b in zip(("u_t", "u_s", "psi"), grads_k, grads_p):
            check(f"hop backward d{gname} p={parity} {tag}", maxdiff(a, b), bar, "staggered_w")


def phase_staggered_kernels(torch):
    print("== 7. staggered_w against its plain version", flush=True)
    from latticeqcd_torch import validation_pbp
    from latticeqcd_torch.io import load_u
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    for lat in STAGGERED_LATTICES:
        half = (lat[0] // 2,) + lat[1:] + (3,)
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            (u_e, u_o), g = _packed_links(torch, lat, dtype, seed=sum(lat) + 1)
            x = torch.randn(half, dtype=dtype, device=u_e.device, generator=g)
            cot = torch.randn(half, dtype=dtype, device=u_e.device, generator=g)
            tag = f"{'x'.join(map(str, lat))} {name}"
            _staggered_checks(torch, sk, u_e, u_o, x, cot, MASS, tag, BARS[name])
    # the pbp anchor's inputs (phase 16): the JAX chain's thermalised beta = 5.6 links with the
    # staggered boundary phases, m = 0.025
    lat = validation_pbp.LAT
    half = (lat[0] // 2,) + lat[1:] + (3,)
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        u = apply_boundary_phases(load_u(validation_pbp.checkpoint_path(5.6), dtype, "cuda"))
        u_e, u_o = eo_pack.pack_links(u, lat)
        g = torch.Generator(device=u.device).manual_seed(56)
        x = torch.randn(half, dtype=dtype, device=u.device, generator=g)
        cot = torch.randn(half, dtype=dtype, device=u.device, generator=g)
        _staggered_checks(torch, sk, u_e, u_o, x, cot, validation_pbp.MASS,
                          f"pbp56_ckpt.npz m={validation_pbp.MASS} {name}", BARS[name])


def phase_staggered_timing(torch):
    print("== 8. staggered_w timing at 16^3x32", flush=True)
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk

    lat = MAIN
    sites = lat[0] * lat[1] * lat[2] * lat[3] // 2
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = []
            for seed in (8, 9, 10):
                (u_e, u_o), g = _packed_links(torch, lat, dtype, seed=seed)
                sets.append((u_e, u_o, torch.randn((lat[0] // 2,) + lat[1:] + (3,), dtype=dtype,
                                                   device=u_e.device, generator=g)))
            u_e, u_o, x = sets[0]
            # least bytes at complex64, per even or target site: the links of both parities
            # once (576 B), the input field once (24 B), the output once (24 B); about 570 flop
            # per target site for one hop, 1150 for W
            _time_case(torch, "staggered W", name,
                       [lambda s=s: sk.staggered_w(*s, MASS) for s in sets],
                       lambda: sk.staggered_w_reference(u_e, u_o, x, MASS),
                       f * 624 * sites, 1150 * sites)
            _time_case(torch, "staggered hop", name,
                       [lambda s=s: sk.staggered_hop_packed(*s, 0) for s in sets],
                       lambda: sk.staggered_hop_packed_reference(u_e, u_o, x, 0),
                       f * 624 * sites, 570 * sites)
            fused = [lambda s=s: sk.staggered_w_fused(*s, MASS) for s in sets]
            _time_case(torch, "staggered W, one launch", name, fused,
                       lambda: sk.staggered_w_reference(u_e, u_o, x, MASS),
                       f * 624 * sites, 1150 * sites)
            # the one-launch W against the paths' two-launch W, cold, in turns
            two = [lambda s=s: sk.staggered_w(*s, MASS) for s in sets]
            turns = {"fused": [], "two": []}
            for label in ("fused", "two", "two", "fused"):
                turns[label].append(_time_device(torch, fused if label == "fused" else two))
            bound = STATE["timing"][("staggered W", name)]["bound_ms"]
            print(f"  staggered W {name} in turns (fused, two-launch, two-launch, fused), cold: "
                  f"one launch {' '.join(f'{t * 1e3:.1f}' for t in turns['fused'])} us, two "
                  f"launches {' '.join(f'{t * 1e3:.1f}' for t in turns['two'])} us, bound "
                  f"{bound * 1e3:.1f} us (aim, 50% of the bound: {bound * 2e3:.1f} us): one launch "
                  f"{100 * bound / statistics.mean(turns['fused']):.1f}%, two launches "
                  f"{100 * bound / statistics.mean(turns['two']):.1f}% of bound [{STATE['smi']}]",
                  flush=True)


def phase_staggered_trajectory_agreement(torch):
    print("== 9. 4^4 complex128 staggered trajectories: kernel path against plain path", flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    u = fields.hot_start(lat, 3, seed=13, dtype=torch.complex128, device=dev)
    for nf in (2, 4):
        fa = StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=nf, eps_cg=1e-19)
        hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=10, fermi_action=fa)
        _trajectory_pair(torch, f"Nf={nf}", hmc, u, 14 + nf)

    # Nf=2 reversibility: integrate forward, flip the momenta, integrate back
    fa = StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=2, eps_cg=1e-19)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=10, fermi_action=fa)
    draws = Draws.sample(hmc, u, torch.Generator(device=dev).manual_seed(15))
    _, phi = fa.sample_pseudofermion(u, normals=draws.xi)
    force_f = lambda uu: fa.force(uu, phi)
    force_g = lambda uu: ga.force(hmc.action, uu)
    u1, h1 = integrators.leapfrog_qpq(u, draws.momentum(u), force_g, 0.1, 10, force_f)
    u2, _ = integrators.leapfrog_qpq(u1, -h1, force_g, 0.1, 10, force_f)
    check("Nf=2 MD reversibility max|dU|", maxdiff(u2, u), 1e-8)


def phase_staggered_main_path(torch):
    print("== 10. staggered main path: run_lqcd_params, 16^3x32 staggered Nf=4 HMC and Nf=2 "
          "RHMC, complex64", flush=True)
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.hmc import HMC

    step = HMC.step
    per_trajectory = []

    def counted_step(self, *args, **kwargs):
        w0, f0 = sk.w_launches, sk.fused_launches
        out = step(self, *args, **kwargs)
        per_trajectory.append((sk.w_launches - w0, sk.fused_launches - f0))
        return out

    torch.cuda.synchronize()
    sk.launches = sk.w_launches = sk.fused_launches = 0
    for nf in (4, 2):
        p = Params(
            L=MAIN, NC=3, beta=5.7, initial="hot", update_method="HMC", quench=False,
            Dirac_operator="Staggered", mass=MASS, Nf=nf, BoundaryCondition=(1, 1, 1, -1),
            QPQ=True, dtau=0.02, MDsteps=10, Nsteps=2, eps=1e-12, MaxCGstep=3000,
            randomseed=3, verboselevel=2,
            measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
        )
        history = []
        per_trajectory.clear()
        with mock.patch.object(HMC, "step", counted_step):
            plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                                   history=history)
        torch.cuda.synchronize()
        for rec, (w_count, fused_count) in zip(history, per_trajectory):
            cg = [c for c in rec["cg"] if "shifts" not in c]
            ms = [c for c in rec["cg"] if "shifts" in c]
            poles = max((c["shifts"] for c in ms), default=0)
            print(f"  Nf={nf} trajectory {rec['itrj']}: {rec['seconds']:.3f} s  CG iterations "
                  f"{sum(c['iterations'] for c in cg)} in {len(cg)} solves  multi-shift iterations "
                  f"{sum(c['iterations'] for c in ms)} in {len(ms)} solves of {poles} poles  "
                  f"dH {rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  "
                  f"W launches: two-launch {w_count}, one-launch {fused_count}  "
                  f"[{STATE['smi']}]", flush=True)
            if not math.isfinite(rec["dH"]):
                fail(f"non-finite dH {rec['dH']}")
            if any(c["iterations"] >= p.MaxCGstep for c in rec["cg"]):
                fail(f"a staggered solve stopped at maxiter {p.MaxCGstep}")
        if len(per_trajectory) != len(history) or not history:
            fail("the staggered main path ran no trajectory")
        print(f"  Nf={nf} final plaquette {plaq:.8f}")
        if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
            fail(f"plaquette {plaq} outside (0, 1)")
    torch.cuda.synchronize()
    STATE["launches"].setdefault("staggered_w", {})["staggered main path"] = sk.launches
    print(f"  staggered_w launches on the main path: {sk.launches} ({sk.w_launches} of the "
          f"two-launch W, {sk.launches - sk.w_launches} of the hop); staggered_w_fused "
          f"{sk.fused_launches}")
    if sk.w_launches == 0 or sk.launches == sk.w_launches:
        fail("the staggered main path did not launch both staggered_w entry points")
    if sk.fused_launches:
        fail("the staggered main path launched staggered_w_fused, which no path calls")


def phase_window(torch):
    print("== 11. wilson_window against its plain version and against wilson_hop's full mode",
          flush=True)
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    for lat in WINDOW_LATTICES:
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            bar = BARS[name]
            tag = f"{'x'.join(map(str, lat))} {name}"
            u, psi, g = _fields(torch, lat, dtype, seed=sum(lat) + 2)
            got = ww.wilson_window(u, psi, KAPPA)
            torch.cuda.synchronize()
            check(f"window D {tag}", maxdiff(got, wk.dslash_reference(u, psi, KAPPA)), bar,
                  "wilson_window")
            check(f"window D against wilson_hop full {tag}",
                  maxdiff(got, wk.wilson_dslash(u, psi, KAPPA)), bar)
            cot = torch.randn(psi.shape, dtype=dtype, device=psi.device, generator=g)
            leaves = [t.detach().clone().requires_grad_(True) for t in (u, psi)]
            grads_k = torch.autograd.grad(ww.wilson_window(*leaves, KAPPA), leaves, cot)
            grads_p = torch.autograd.grad(wk.dslash_reference(*leaves, KAPPA), leaves, cot)
            torch.cuda.synchronize()
            for gname, a, b in zip(("u", "psi"), grads_k, grads_p):
                check(f"window backward d{gname} {tag}", maxdiff(a, b), bar, "wilson_window")
    _r_mode_window(torch)


def phase_window_timing(torch):
    print("== 12. wilson_window timing at 16^3x32, beside wilson_hop's full mode", flush=True)
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    lat = MAIN
    vol = lat[0] * lat[1] * lat[2] * lat[3]
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = [_fields(torch, lat, dtype, seed=seed)[:2] for seed in (7, 8, 9)]
            u, psi = sets[0]
            # least bytes at complex64: each link and spinor read once, the output written
            # once (480 B/site); 1320 flop per site
            _time_case(torch, "window D", name,
                       [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in sets],
                       lambda: wk.dslash_reference(u, psi, KAPPA), f * 480 * vol, 1320 * vol)
            # the r mode: the same bytes, the spin matrix on four spins of U psi
            _time_case(torch, f"window D r={R_MODE}", name,
                       [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA, R_MODE) for s in sets],
                       lambda: wk.dslash_reference(u, psi, KAPPA, R_MODE), f * 480 * vol,
                       R_FLOP_WINDOW * vol)
            # the redesigned window D against wilson_hop's full D, cold, in turns
            full = [lambda s=s: wk.wilson_dslash(s[0], s[1], KAPPA) for s in sets]
            window = [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in sets]
            turns = {"window": [], "full": []}
            for label in ("window", "full", "full", "window"):
                turns[label].append(_time_device(torch, window if label == "window" else full))
            bound = STATE["timing"][("window D", name)]["bound_ms"]
            print(f"  window D {name} in turns (window, full, full, window), cold: window "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['window'])} us, wilson_hop full D "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['full'])} us, bound "
                  f"{bound * 1e3:.1f} us: window "
                  f"{100 * bound / statistics.mean(turns['window']):.1f}%, full "
                  f"{100 * bound / statistics.mean(turns['full']):.1f}% of bound [{STATE['smi']}]",
                  flush=True)
            if statistics.mean(turns["window"]) > statistics.mean(turns["full"]):
                fail(f"wilson_window is slower than wilson_hop's full D at {name}")


def _plain_kernels():
    """Swap every kernel wrapper's launch for its plain version (this run only)."""
    from contextlib import ExitStack

    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    stack = ExitStack()
    for mod, name, plain in ((wk, "_dslash", wk.dslash_reference),
                             (wk, "_hop_packed", wk.hop_packed_reference),
                             (ww, "_dslash", wk.dslash_reference),
                             (sk, "_w", sk.staggered_w_reference),
                             (sk, "_hop_packed", sk.staggered_hop_packed_reference)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def _launch_counts():
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    return {"wilson_window": ww.launches, "wilson_hop_packed": wk.launches,
            "staggered_w": sk.launches}


def _trajectory_pair(torch, label, hmc, u, seed):
    """One trajectory through the kernels and one through their plain versions from the same
    draws (uniform 0: both accepted, so U' compares the evolved links)."""
    from latticeqcd_torch.updates.hmc import Draws

    drawn = Draws.sample(hmc, u, torch.Generator(device=u.device).manual_seed(seed))
    draws = Draws(drawn.mom, drawn.xi, 0.0)
    before = _launch_counts()
    u_k, st_k = hmc.step(u, draws=draws)
    after = _launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    with _plain_kernels():
        u_p, st_p = hmc.step(u, draws=draws)
    if _launch_counts() != after:
        fail(f"{label}: the plain-path trajectory launched a kernel")
    print(f"  {label}: kernel dH {st_k['dH']:.12f} ({launched} launches, "
          f"{sum(c['iterations'] for c in st_k['cg'])} CG iterations); plain dH "
          f"{st_p['dH']:.12f}", flush=True)
    if not launched:
        fail(f"{label}: the kernel path of the trajectory launched no kernel")
    check(f"{label} trajectory |ddH|", abs(st_k["dH"] - st_p["dH"]), 1e-9)
    check(f"{label} trajectory max|dU|", maxdiff(u_k, u_p), 1e-10)
    if st_k["accepted"] != st_p["accepted"]:
        fail(f"{label}: kernel and plain trajectories disagree on accept")
    return launched


def _kernel_vs_plain(label, fn, rtol=1e-9):
    """fn() (numbers on the host) through the kernels and through their plain versions, held
    to rtol relative; fails if the kernel path launched nothing or the plain path anything.
    Returns the kernel path's launches."""
    import numpy as np

    before = _launch_counts()
    got = np.asarray(fn(), dtype=np.float64)
    launched = {k: v - before[k] for k, v in _launch_counts().items() if v > before[k]}
    with _plain_kernels():
        ref = np.asarray(fn(), dtype=np.float64)
    if _launch_counts() != {k: before[k] + launched.get(k, 0) for k in before}:
        fail(f"{label}: the plain path launched a kernel")
    if not launched:
        fail(f"{label}: the kernel path launched no kernel")
    err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))
    print(f"  {label}: {launched} launches", flush=True)
    check(f"{label} max relative diff", err, rtol)
    return launched


def phase_measurement_agreement(torch):
    print("== 13. 4^4 complex128 measurements: kernel path against plain path", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import fermionic
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, gaussian_spinor

    dev = torch.device("cuda")
    dtype = torch.complex128
    rng = np.random.default_rng(16)
    # relative |r|^2 1e-24: both paths' solutions within ~1e-12 of the exact one, so the
    # 1e-9 bar compares the kernels and not the solver's stopping point
    tight = 1e-24
    wilson = WilsonDirac(kappa=KAPPA)
    both = _kernel_vs_plain
    lat = (4, 4, 4, 4)
    u = fields.hot_start(lat, 3, seed=17, dtype=dtype, device=dev)
    both("Wilson pion correlator", lambda: fermionic.pion_correlator(u, wilson, eps=tight))
    draws = rng.integers(0, 4, (3,) + lat + (4, 3))
    both("Wilson pbp per noise",
         lambda: fermionic.chiral_condensate(u, wilson, nr=3, draws=draws, eps=tight)[1])
    stag = StaggeredDirac(mass=MASS, lattice=lat)
    draws = rng.integers(0, 4, (3,) + lat + (3,))
    both("staggered pbp per noise",
         lambda: fermionic.chiral_condensate(u, stag, nr=3, nf_factor=0.5, draws=draws,
                                             eps=tight)[1])
    v0 = gaussian_spinor(lat, 3, dtype=dtype, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(18))
    both("Wilson low spectrum", lambda: fermionic.dirac_low_spectrum(u, wilson, k=4, m=32, v0=v0))
    odd = (3, 5, 2, 6)
    u_odd = fields.hot_start(odd, 3, seed=19, dtype=dtype, device=dev)
    both(f"CGNE pion correlator {'x'.join(map(str, odd))}",
         lambda: fermionic.pion_correlator(u_odd, wilson, eps=tight))


def phase_measurement_path(torch):
    print("== 14. measurement path: run_lqcd_params, 16^3x32 Wilson HMC, complex64, with the "
          "fermionic measurements at itrj 0 and 1", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params

    maxcg = 3000
    wilson = {"Dirac_operator": "Wilson", "hop": KAPPA}
    methods = [
        {"methodname": "Pion_correlator", "fermion_parameters": wilson, "MaxCGstep": maxcg},
        {"methodname": "Chiral_condensate", "fermion_parameters": wilson, "Nr": 10,
         "MaxCGstep": maxcg},
        {"methodname": "Chiral_condensate", "Nr": 10, "MaxCGstep": maxcg,
         "fermion_parameters": {"Dirac_operator": "Staggered", "mass": MASS, "Nf": 4}},
        {"methodname": "Dirac_spectrum", "fermion_parameters": wilson, "Neig": 8,
         "Nlanczos": 48},
    ]
    p = Params(
        L=MAIN, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=False,
        Dirac_operator="Wilson", hop=KAPPA, r=1.0, BoundaryCondition=(1, 1, 1, -1),
        QPQ=True, dtau=0.02, MDsteps=10, Nsteps=1, eps=1e-12, MaxCGstep=3000,
        randomseed=3, verboselevel=1,
        measurement_methods=[{**m, "measure_every": 1} for m in methods],
    )
    records = []

    def timed(cls):
        measure = cls.measure

        def wrapper(self, u, itrj, additional_string=""):
            torch.cuda.synchronize()
            before = _launch_counts()
            t0 = time.time()
            line = measure(self, u, itrj, additional_string)
            torch.cuda.synchronize()
            records.append({
                "method": self.name,
                "operator": self.params["fermion_parameters"]["Dirac_operator"], "itrj": itrj, "seconds": time.time() - t0, "value": self.value,
                "solves": self.solves,
                "launches": {k: v - before[k] for k, v in _launch_counts().items()}})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    torch.cuda.synchronize()
    ww.launches = wk.launches = sk.launches = sk.w_launches = sk.fused_launches = 0
    wk.site_launches.update(full=0, packed=0)
    with timed(scheduler.PionCorrelatorMeasurement), \
            timed(scheduler.ChiralCondensateMeasurement), \
            timed(scheduler.DiracSpectrumMeasurement):
        t0 = time.time()
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda")
    torch.cuda.synchronize()
    total = time.time() - t0
    counts = _launch_counts()
    for name, n in counts.items():
        STATE["launches"].setdefault(name, {})["measurement path"] = n
    for rec in records:
        value = rec["value"]
        solves = rec["solves"] or []
        iters = sum(c["iterations"] for c in solves)
        if rec["method"] == "Dirac_spectrum":
            shown = " ".join(f"{v:.6g}" for v in value)
            work = f"{len(value)} Ritz values from 48 Lanczos steps"
        elif rec["method"] == "Chiral_condensate":
            shown = f"pbp {value[0]:.8g}"
            value = [value[0]] + list(value[1])
        else:
            shown = "C(t) " + " ".join(f"{v:.4g}" for v in value[:4]) + " ..."
        if rec["method"] != "Dirac_spectrum":
            work = f"CG iterations {iters} in {len(solves)} solve(s) of " \
                   f"{sum(c.get('rhs', 1) for c in solves)} RHS"
        print(f"  itrj {rec['itrj']} {rec['method']} ({rec['operator']}): {rec['seconds']:.3f} s  "
              f"{work}  launches {rec['launches']}  {shown}  [{STATE['smi']}]", flush=True)
        if not np.all(np.isfinite(np.asarray(value, dtype=np.float64))):
            fail(f"{rec['method']} gave a value that is not finite")
        if any(c["iterations"] >= maxcg for c in solves):
            fail(f"a {rec['method']} solve stopped at MaxCGstep {maxcg}")
        if rec["method"] == "Pion_correlator" and not np.all(np.asarray(value) > 0):
            fail("the pion correlator is not positive")
        if rec["method"] == "Dirac_spectrum" and not (
                np.all(np.diff(value) >= 0) and np.all(np.asarray(value) > 0)):
            fail("the Wilson low eigenvalues are not ascending and positive")
    if sorted({(r["method"], r["operator"], r["itrj"]) for r in records}) != sorted(
            {(m["methodname"], m["fermion_parameters"]["Dirac_operator"], i)
             for m in methods for i in (0, 1)}):
        fail("the measurement path did not run every method at itrj 0 and 1")
    print(f"  run_lqcd_params {total:.3f} s, final plaquette {plaq:.8f}; launches on the "
          f"measurement path (trajectory included): {counts}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"the measurement path launched {name} no time")
    if wk.site_launches["packed"]:
        fail(f"the measurement path launched wilson_hop's packed mode {wk.site_launches}")
    print(f"  staggered_w's two-launch W {sk.w_launches}, staggered_w_fused {sk.fused_launches}")
    if sk.fused_launches:
        fail("the measurement path launched staggered_w_fused, which no path calls")


def _bits(t):
    """A complex tensor's bits as integers of its real type's width."""
    import torch

    return torch.view_as_real(t).view(torch.int32 if t.dtype == torch.complex64 else torch.int64)


def check_same(label: str, a, b):
    """Fail unless two link tensors are equal bit for bit."""
    import torch

    STATE["checks"] += 1
    ok = a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: {'bit for bit equal' if ok else 'NOT equal'}",
          flush=True)
    if not ok:
        fail(f"{label}: not bit for bit equal")


def _disk_params(**kw):
    from latticeqcd_torch.system.params import Params

    base = dict(
        L=MAIN, NC=3, beta=6.0, initial="cold", update_method="HMC", quench=False,
        Dirac_operator="Wilson", hop=KAPPA, r=1.0, BoundaryCondition=(1, 1, 1, -1),
        QPQ=True, dtau=0.02, MDsteps=10, Nsteps=2, eps=1e-12, MaxCGstep=3000,
        randomseed=3, verboselevel=1,
        measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
    )
    base.update(kw)
    return Params(**base)


def _mb(path) -> str:
    return f"{os.path.getsize(path) / 1e6:.1f} MB"


def phase_disk(torch):
    print("== 15. configurations on disk: run_lqcd_params at 16^3x32 Wilson HMC, complex64, cold "
          "start, saving ILDG and NPZ; Fileloading; resume", flush=True)
    import shutil
    import tempfile

    import numpy as np

    from latticeqcd_torch import io
    from latticeqcd_torch.io import jld2
    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system import lqcd

    tmp = tempfile.mkdtemp(prefix="chip_smoke_disk_")
    save = lqcd.Savedata.save
    held, label = {}, [None]

    def holding(self, u, itrj, generator=None):
        seconds = save(self, u, itrj, generator)
        if seconds is not None:
            held[(label[0], itrj)] = u.clone()
        return seconds

    launches = {}

    def run(name, p, **kw):
        """run_lqcd_params with wilson_hop_packed's count set to 0 just before and read just
        after; the links of every save are kept under name."""
        label[0] = name
        history = []
        torch.cuda.synchronize()
        wk.launches = 0
        wk.site_launches.update(full=0, packed=0)
        with mock.patch.object(lqcd.Savedata, "save", holding):
            plaq = lqcd.run_lqcd_params(p, make_dirs=True, dtype=torch.complex64, device="cuda",
                                        history=history, **kw)
        torch.cuda.synchronize()
        launches[name] = wk.launches
        for rec in history:
            dh = "" if rec["dH"] is None else f"dH {rec['dH']:.6f}  accepted {rec['accepted']}  "
            saved = "" if rec["save_seconds"] is None else f"  saved in {rec['save_seconds']:.3f} s"
            print(f"  {name} itrj {rec['itrj']}: {rec['seconds']:.3f} s  {dh}CG iterations "
                  f"{sum(c['iterations'] for c in rec['cg'])}{saved}  [{STATE['smi']}]",
                  flush=True)
            if rec["dH"] is not None and not math.isfinite(rec["dH"]):
                fail(f"{name}: non-finite dH {rec['dH']}")
            if any(c["iterations"] >= p.MaxCGstep for c in rec["cg"]):
                fail(f"{name}: a CG stopped at MaxCGstep")
        if wk.launches == 0 or wk.site_launches["packed"]:
            fail(f"{name}: wilson_hop_packed launched {wk.launches} times, wilson_hop's packed "
                 f"mode {wk.site_launches['packed']}")
        return plaq, history

    def timed_load(fn, loader):
        torch.cuda.synchronize()
        t0 = time.time()
        u = loader(fn)
        torch.cuda.synchronize()
        return u, time.time() - t0

    try:
        lat, c64 = MAIN, dict(dtype=torch.complex64, device="cuda")
        loaders = {"ILDG": lambda fn: io.load_ildg(fn, lat, 3, **c64),
                   "NPZ": lambda fn: io.load_u(fn, **c64)}
        runs = {}
        for fmt, ext in (("ILDG", "ildg"), ("NPZ", "npz")):
            d = os.path.join(tmp, fmt)
            os.makedirs(d)
            p = _disk_params(saveU_format=fmt, saveU_dir=d, saveU_every=1,
                             measuredir=os.path.join(d, "measure"))
            runs[fmt] = run(fmt, p)
            if sum(r["accepted"] for r in runs[fmt][1]) == 0:
                fail(f"{fmt}: no trajectory accepted from the cold start, the links never moved")
            for itrj in (1, 2):
                fn = os.path.join(d, f"conf_{itrj:08d}.{ext}")
                u, seconds = timed_load(fn, loaders[fmt])
                print(f"  {fmt} conf_{itrj:08d}.{ext}: {_mb(fn)}, saved in "
                      f"{runs[fmt][1][itrj - 1]['save_seconds']:.3f} s (with checkpoint.npz), "
                      f"loaded in {seconds:.3f} s", flush=True)
                check_same(f"{fmt} conf_{itrj:08d} loaded against the links the run held", u,
                           held[(fmt, itrj)])
            ck = io.load_checkpoint(os.path.join(d, "checkpoint.npz"), **c64)
            print(f"  {fmt} checkpoint.npz: {_mb(os.path.join(d, 'checkpoint.npz'))}, itrj "
                  f"{ck['itrj']}, generator state {tuple(ck['torch_rng_state'].shape)}")
            if ck["itrj"] != 2 or "torch_rng_state" not in ck:
                fail(f"{fmt}: checkpoint.npz lacks itrj 2 or the generator state")
            check_same(f"{fmt} checkpoint.npz links", ck["u"], held[(fmt, 2)])
        check_same("the ILDG and the NPZ runs' links at itrj 2 (the same run twice)",
                   held[("ILDG", 2)], held[("NPZ", 2)])

        u = held[("ILDG", 2)]
        round_trips = [("BridgeText", "txt", io.save_bridge_text,
                        lambda fn: io.load_bridge_text(fn, lat, 3, **c64))]
        if jld2.h5py is not None:
            round_trips.append(("JLD", "jld2", io.save_jld2,
                                lambda fn: io.load_jld2(fn, lat, 3, **c64)))
        else:
            STATE["checks"] += 1
            try:
                io.load_jld2(os.path.join(tmp, "conf.jld2"), lat, 3, **c64)
                fail("load_jld2 without h5py did not raise ImportError")
            except ImportError as exc:
                print(f"  JLD: h5py does not import here; the clear error is raised: {exc}")
                if "JLD2 I/O needs h5py" not in str(exc):
                    fail("the JLD error without h5py does not say what it needs")
        for fmt, ext, saver, loader in round_trips:
            fn = os.path.join(tmp, f"conf.{ext}")
            t0 = time.time()
            saver(fn, u)
            seconds = time.time() - t0
            back, load_s = timed_load(fn, loader)
            print(f"  {fmt} round trip through io{' (h5py imports)' if fmt == 'JLD' else ''}: "
                  f"{_mb(fn)}, saved in {seconds:.3f} s, loaded in {load_s:.3f} s", flush=True)
            check_same(f"{fmt} loaded against the links saved", back, u)

        # Fileloading over the ILDG files: Plaquette and a Wilson Chiral_condensate
        wilson = {"Dirac_operator": "Wilson", "hop": KAPPA}
        maxcg = 3000
        records = []
        measure = scheduler.ChiralCondensateMeasurement.measure

        def recorded(self, uu, itrj, additional_string=""):
            line = measure(self, uu, itrj, additional_string)
            records.append((itrj, self.value[0], list(self.solves)))
            return line

        fl = os.path.join(tmp, "fileloading")
        p = _disk_params(update_method="Fileloading", loadU_format="ILDG",
                         loadU_dir=os.path.join(tmp, "ILDG"), measuredir=fl,
                         measurement_methods=[
                             {"methodname": "Plaquette", "measure_every": 1},
                             {"methodname": "Chiral_condensate", "measure_every": 1, "Nr": 2,
                              "MaxCGstep": maxcg, "fermion_parameters": wilson}])
        with mock.patch.object(scheduler.ChiralCondensateMeasurement, "measure", recorded):
            _, fl_history = run("Fileloading", p)
        if [r["itrj"] for r in fl_history] != [1, 2]:
            fail(f"Fileloading ran {len(fl_history)} steps over 2 ILDG files")
        for itrj, pbp, solves in records:
            iters = [c["iterations"] for c in solves]
            print(f"  Fileloading itrj {itrj}: Wilson pbp {pbp:.8g}, CG iterations {iters}")
            if not math.isfinite(pbp) or any(i >= maxcg for i in iters):
                fail("the Fileloading Chiral_condensate is not finite or hit MaxCGstep")
        hmc_lines = open(os.path.join(tmp, "ILDG", "measure", "Plaquette.txt")).read()
        fl_lines = open(os.path.join(fl, "Plaquette.txt")).read()
        STATE["checks"] += 1
        print(f"  Fileloading Plaquette.txt against the HMC run's: {fl_lines.splitlines()}")
        if fl_lines != hmc_lines:
            fail(f"the Fileloading plaquettes differ from the HMC run's:\n{hmc_lines}")

        # resume: 4 trajectories straight against the NPZ run resumed for 2 more
        for name, kw, d in (("straight", {}, os.path.join(tmp, "straight")),
                            ("resumed", {"resume_checkpoint": os.path.join(tmp, "NPZ",
                                                                           "checkpoint.npz")},
                             os.path.join(tmp, "NPZ"))):
            os.makedirs(d, exist_ok=True)
            # the resumed run appends to the series of the NPZ run it continues
            p = _disk_params(Nsteps=4, saveU_format="NPZ", saveU_dir=d, saveU_every=2,
                             measuredir=os.path.join(d, "measure"))
            runs[name] = run(name, p, **kw)
        if [r["itrj"] for r in runs["resumed"][1]] != [3, 4]:
            fail("the resumed run did not continue at itrj 3")
        dh_straight = [r["dH"] for r in runs["straight"][1]]
        dh_resumed = [r["dH"] for r in runs["NPZ"][1] + runs["resumed"][1]]
        print(f"  dH straight {dh_straight}; 2 + resumed 2 {dh_resumed}")
        STATE["checks"] += 1
        if dh_straight != dh_resumed:
            fail("the resumed trajectories' dH differ from the straight run's")
        check_same("links at itrj 4: 4 straight against 2 + resume 2", held[("resumed", 4)],
                   held[("straight", 4)])
        check_same("conf_00000004.npz: straight against resumed",
                   io.load_u(os.path.join(tmp, "straight", "conf_00000004.npz"), **c64),
                   io.load_u(os.path.join(tmp, "NPZ", "conf_00000004.npz"), **c64))
        series = {n: open(os.path.join(tmp, n, "measure", "Plaquette.txt")).read()
                  for n in ("straight", "NPZ")}
        print(f"  Plaquette.txt of 2 + resumed 2: {series['NPZ'].splitlines()}")
        STATE["checks"] += 1
        if series["NPZ"] != series["straight"]:
            fail(f"the resumed Plaquette series differs from the straight run's:\n"
                 f"{series['straight']}")
        STATE["launches"].setdefault("wilson_hop_packed", {})["configurations on disk"] = \
            sum(launches.values())
        print(f"  wilson_hop_packed launches per run: {launches}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_anchor(torch):
    print("== 16. the Nf=4 staggered pbp anchor, short: 12^3x8 from pbp56_ckpt.npz, m = 0.025, "
          "2 trajectories", flush=True)
    import shutil
    import tempfile

    from latticeqcd_torch import validation_pbp
    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.system.lqcd import run_lqcd_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_anchor_")
    records = []
    measure = scheduler.ChiralCondensateMeasurement.measure

    def recorded(self, u, itrj, additional_string=""):
        line = measure(self, u, itrj, additional_string)
        records.append((itrj, self.value[0], list(self.solves)))
        return line

    try:
        p = validation_pbp.anchor_params(5.6, 2, tmp)
        history = []
        torch.cuda.synchronize()
        sk.launches = sk.w_launches = sk.fused_launches = 0
        with mock.patch.object(scheduler.ChiralCondensateMeasurement, "measure", recorded):
            run_lqcd_params(p, make_dirs=True, dtype=torch.complex64, device="cuda",
                            history=history)
        torch.cuda.synchronize()
        counts = (sk.launches, sk.w_launches, sk.fused_launches)
        plaq_lines = open(os.path.join(tmp, "Plaquette.txt")).read().split("\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    STATE["launches"].setdefault("staggered_w", {})["pbp anchor"] = counts[0]
    for rec in history:
        iters = [c["iterations"] for c in rec["cg"]]
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  dH {rec['dH']:.6f}  accepted "
              f"{rec['accepted']}  plaquette {rec['plaq']:.8f}  CG {sum(iters)} iterations in "
              f"{len(iters)} solves ({sum(iters) / max(len(iters), 1):.1f} per solve, most "
              f"{max(iters, default=0)})  [{STATE['smi']}]", flush=True)
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if any(i >= p.MaxCGstep for i in iters):
            fail(f"an HMC solve stopped at MaxCGstep {p.MaxCGstep}")
    plaqs = [float(line.split()[1]) for line in plaq_lines if line.strip()]
    for itrj, pbp, solves in records:
        iters = [c["iterations"] for c in solves]
        print(f"  itrj {itrj}: pbp {pbp:.8f} (Nr=2; CG iterations {iters})", flush=True)
        if any(i >= 4000 for i in iters):
            fail("a Chiral_condensate solve stopped at MaxCGstep 4000")
        STATE["checks"] += 1
        if not 0.1239 <= pbp <= 0.1467:
            fail(f"pbp {pbp} outside 0.1239-0.1467 (the JAX series' mean +- 5 std)")
    print(f"  plaquettes {plaqs}; staggered_w launches {counts[0]} ({counts[1]} of the two-launch "
          f"W), staggered_w_fused {counts[2]}")
    STATE["checks"] += 1
    if len(history) != 2 or len(records) != 2 or len(plaqs) != 3:
        fail("the anchor did not run 2 trajectories with measurements at itrj 0 and 2")
    if not all(0.575 <= x <= 0.589 for x in plaqs + [r["plaq"] for r in history]):
        fail(f"a plaquette lies outside 0.575-0.589: {plaqs}")
    if counts[1] == 0 or counts[2]:
        fail("the anchor did not run the two-launch staggered W, or ran the one-launch W")


def _warm_links(torch, lat, nc, seed, device, eps=0.3):
    """exp(i eps H), H traceless hermitian from numpy's default_rng(seed): a plaquette of
    0.7-0.8. An overrelaxation sweep on Haar-random links amplifies rounding by up to 1e6
    (NC = 4), so the 1e-12 comparison of two devices runs on ordered links."""
    import numpy as np

    from latticeqcd_torch.ops import sun

    rng = np.random.default_rng(seed)
    shape = (4, *lat, nc, nc)
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)
    h = 0.5 * (a + np.conj(np.swapaxes(a, -1, -2)))
    h -= np.trace(h, axis1=-2, axis2=-1)[..., None, None] * np.eye(nc) / nc
    return sun.expi_hermitian(torch.from_numpy(h), eps).to(device)


class _HostUniforms:
    """A heatbath sweep's uniforms drawn on the host with numpy, each try's and each
    direction's from its own seed (seed, update, try), so that two devices get the same
    numbers whatever number of tries each makes."""

    def __init__(self, torch, seed):
        self.torch, self.seed, self.update = torch, seed, 0

    def _draw(self, key, n, shape, dtype, device):
        import numpy as np

        r = np.random.default_rng([self.seed, self.update, key]).random((n, *shape))
        return [self.torch.from_numpy(x).to(dtype=dtype, device=device) for x in r]

    def tries(self, shape, dtype, device):
        self.update += 1
        k = 0
        while True:
            k += 1
            r1, r2, r3, r4 = self._draw(k, 4, shape, dtype, device)
            yield r1.clamp_min(1e-30), r2, r3.clamp_min(1e-30), r4

    def direction(self, shape, dtype, device):
        ct, phi = self._draw(0, 2, shape, dtype, device)
        return 2.0 * ct - 1.0, (2 * math.pi) * phi


def phase_quenched_agreement(torch):
    print("== 17. 4^4 complex128 quenched pieces: the card against the CPU", flush=True)
    from latticeqcd_torch.measurements import observables
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.smearing.gradientflow import gradientflow
    from latticeqcd_torch.updates.heatbath import Heatbath

    lat = (4, 4, 4, 4)
    bar = BARS["complex128"]
    for nc in (2, 3, 4):
        act = ga.wilson_gauge_action(nc, 5.7)
        hb = Heatbath(action=act)
        u = _warm_links(torch, lat, nc, 30 + nc, "cpu")
        cpu, gpu = hb.overrelax(u), hb.overrelax(u.cuda())
        check(f"overrelaxation sweep SU({nc}), card vs CPU", maxdiff(gpu.cpu(), cpu), bar)
        s0, s1 = float(ga.action_value(act, u.cuda())), float(ga.action_value(act, gpu))
        check(f"overrelaxation SU({nc}) total action, relative change",
              abs(s1 - s0) / max(1.0, abs(s0)), 1e-8)
    for nc, beta in ((2, 2.2), (3, 5.7)):
        hb = Heatbath(action=ga.wilson_gauge_action(nc, beta))
        u = _warm_links(torch, lat, nc, 40 + nc, "cpu")
        cpu = hb.sweep(u, uniforms=_HostUniforms(torch, 7))
        gpu = hb.sweep(u.cuda(), uniforms=_HostUniforms(torch, 7))
        check(f"heatbath sweep SU({nc}) from host uniforms, card vs CPU", maxdiff(gpu.cpu(), cpu),
              bar)
    u = fields.hot_start(lat, 3, seed=44, dtype=torch.complex128, device="cpu")
    gf = gradientflow(3, nflow=5, eps=0.02)
    cpu, gpu = gf.flow(u), gf.flow(u.cuda())
    check("5 flow steps of 0.02, card vs CPU", maxdiff(gpu.cpu(), cpu), bar)
    ug = u.cuda()
    for kind in ("plaquette", "clover", "improved"):
        check(f"topological charge ({kind}), card vs CPU",
              abs(float(observables.topological_charge(ug, kind))
                  - float(observables.topological_charge(u, kind))), bar)
    check("energy density, card vs CPU",
          abs(float(observables.energy_density(ug)) - float(observables.energy_density(u))), bar)
    err = max(abs(float(observables.wilson_loop_rt(ug, r, t))
                  - float(observables.wilson_loop_rt(u, r, t)))
              for r in range(1, 5) for t in range(1, 5))
    check("Wilson loops W(R, T), R, T <= 4, card vs CPU", err, bar)


def phase_quenched_path(torch):
    print("== 18. quenched path: run_lqcd_params, 16^3x32 SU(3) heatbath with overrelaxation, "
          "complex64, 4 steps, gauge observables, a Wilson pion correlator and the flow",
          flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops import sun
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.smearing.gradientflow import GradientFlow
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.heatbath import Heatbath

    maxcg = 3000
    methods = [
        {"methodname": "Plaquette"},
        {"methodname": "Polyakov_loop"},
        {"methodname": "Topological_charge",
         "kinds_of_topological_charge": ["plaquette", "clover"]},
        {"methodname": "Energy_density"},
        {"methodname": "Wilson_loop", "Rmax": 4, "Tmax": 4},
        {"methodname": "Pion_correlator", "MaxCGstep": maxcg,
         "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12}},
    ]
    flowed = [{"methodname": "Energy_density", "measure_every": 5},
              {"methodname": "Topological_charge", "measure_every": 5}]
    p = Params(
        L=MAIN, NC=3, beta=6.0, initial="cold", update_method="Heatbath", quench=True,
        useOR=True, numOR=3, Nsteps=4, randomseed=5, verboselevel=1,
        measurement_methods=[{**m, "measure_every": 2} for m in methods],
        hasgradientflow=True, numflow=20, Nflow=1, eps_flow=0.02, measurements_for_flow=flowed,
    )
    times = {"heatbath sweep": [], "overrelaxation sweep": [], "flow step": []}
    records, plaqs, last = [], [], {}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key].append(time.time() - t0)
            return out
        return wrapper

    def stepped(self, u, generator=None):
        out = step(self, u, generator)
        plaqs.append(float(ga.mean_plaquette(out[0])))
        last["u"] = out[0]
        return out

    def measured(cls):
        measure = cls.measure

        def wrapper(self, u, itrj, additional_string=""):
            torch.cuda.synchronize()
            t0 = time.time()
            line = measure(self, u, itrj, additional_string)
            torch.cuda.synchronize()
            records.append({"method": self.name, "itrj": itrj, "flow": additional_string,
                            "seconds": time.time() - t0, "line": line,
                            "solves": getattr(self, "solves", None)})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    step = Heatbath.step
    patches = [mock.patch.object(Heatbath, "sweep", timed(Heatbath.sweep, "heatbath sweep")),
               mock.patch.object(Heatbath, "overrelax",
                                 timed(Heatbath.overrelax, "overrelaxation sweep")),
               mock.patch.object(Heatbath, "step", stepped),
               mock.patch.object(GradientFlow, "flow", timed(GradientFlow.flow, "flow step"))]
    patches += [measured(c) for c in (scheduler.PlaquetteMeasurement,
                                      scheduler.PolyakovMeasurement,
                                      scheduler.TopologicalChargeMeasurement,
                                      scheduler.EnergyDensityMeasurement,
                                      scheduler.WilsonLoopMeasurement,
                                      scheduler.PionCorrelatorMeasurement)]
    from contextlib import ExitStack

    history = []
    with ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        torch.cuda.synchronize()
        wk.launches = 0
        t0 = time.time()
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                               history=history)
        torch.cuda.synchronize()
        total = time.time() - t0
        launched = wk.launches
    STATE["launches"].setdefault("wilson_hop_packed", {})["quenched"] = launched
    defect = float(sun.unitarity_defect(last["u"]))
    for key, ts in times.items():
        print(f"  {key}: {len(ts)} calls, median {statistics.median(ts):.4f} s, mean "
              f"{statistics.mean(ts):.4f} s  [{STATE['smi']}]", flush=True)
    for rec in history:
        print(f"  step {rec['itrj']}: {rec['seconds']:.3f} s (sweep + 3 overrelaxations), flow and "
              f"its measurements {rec['flow_seconds']:.3f} s, plaquette {plaqs[rec['itrj'] - 1]:.8f}",
              flush=True)
    per_method = {}
    for rec in records:
        kind = rec["method"] + (" (flowed)" if rec["flow"] else "")
        per_method.setdefault(kind, []).append(rec["seconds"])
        values = [float(x) for line in rec["line"].splitlines() for x in line.split("#")[0].split()]
        if not rec["flow"] or int(rec["flow"].split()[1]) % 10 == 0:
            print(f"  itrj {rec['itrj']} {rec['flow']}{rec['method']}: {rec['seconds']:.4f} s  "
                  f"{rec['line'].splitlines()[-1][:110]}", flush=True)
        if not all(math.isfinite(v) for v in values):
            fail(f"{kind} gave a value that is not finite: {rec['line']}")
        if rec["method"] == "Pion_correlator":
            iters = [c["iterations"] for c in rec["solves"]]
            print(f"    pion CG iterations {sum(iters)} in {len(iters)} solves (most "
                  f"{max(iters)})", flush=True)
            if max(iters) >= maxcg:
                fail(f"a pion correlator solve stopped at MaxCGstep {maxcg}")
    for kind, ts in sorted(per_method.items()):
        print(f"  {kind}: {len(ts)} calls, median {statistics.median(ts):.4f} s  "
              f"[{STATE['smi']}]", flush=True)
    print(f"  run_lqcd_params {total:.3f} s, final plaquette {plaq:.8f}, unitarity defect "
          f"{defect:.3e}; wilson_hop_packed launches {launched}", flush=True)
    STATE["checks"] += 1
    if len(plaqs) != 4 or not all(0.55 <= x <= 1.0 for x in plaqs):
        fail(f"a plaquette after a step lies outside 0.55-1.0: {plaqs}")
    STATE["checks"] += 1
    if defect > 1e-4:
        fail(f"unitarity defect {defect} after the run exceeds 1e-4")
    want = {(m["methodname"], i) for m in methods for i in (0, 2, 4)}
    if {(r["method"], r["itrj"]) for r in records if not r["flow"]} != want:
        fail("the quenched path did not measure every method at itrj 0, 2 and 4")
    flows = {}
    for rec in records:
        if rec["flow"] and rec["method"] == "Energy_density":
            flows.setdefault(rec["itrj"], []).append(
                float(rec["line"].split("#")[0].split()[-1]))
    STATE["checks"] += 1
    if sorted(flows) != [1, 2, 3, 4] or any(len(e) != 4 for e in flows.values()):
        fail(f"the flow did not measure E at flow steps 5, 10, 15 and 20 of every step: {flows}")
    # E is Re tr(W W) of the untraced clover sums over NV 6 NC 8, 1 on unit links: as the
    # flow smooths the links the field-strength part 1 - E falls
    for itrj, es in flows.items():
        print(f"  step {itrj}: flowed E at flow steps 5, 10, 15, 20: {es}", flush=True)
        if not all(1.0 - b < 1.0 - a for a, b in zip(es, es[1:])):
            fail(f"the flowed E of step {itrj} does not move toward 1: {es}")
    STATE["checks"] += 1
    if launched == 0:
        fail("the quenched path launched wilson_hop_packed no time")


def phase_plaquette_anchor(torch):
    print("== 19. the 12^4 plaquette anchor, short: beta = 6.0, complex64, cold start, 60 heatbath "
          "sweeps", flush=True)
    import shutil
    import tempfile

    import numpy as np

    from latticeqcd_torch import validation_plaq
    from latticeqcd_torch.analysis import read_measurement_series
    from latticeqcd_torch.system.lqcd import run_lqcd_params

    tmp = tempfile.mkdtemp(prefix="chip_smoke_plaq_")
    history = []
    try:
        run_lqcd_params(validation_plaq.anchor_params(6.0, 60, tmp), make_dirs=True,
                        dtype=torch.complex64, device="cuda", history=history)
        itrj, plaq = read_measurement_series(os.path.join(tmp, "Plaquette.txt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = [r["seconds"] for r in history]
    window = plaq[itrj > 30, 0]
    mean = float(np.mean(window))
    ref = validation_plaq.JAX_CHAIN[6.0]["plaq"]
    print(f"  {len(history)} sweeps, {statistics.median(seconds):.4f} s per sweep (median; mean "
          f"{statistics.mean(seconds):.4f})  [{STATE['smi']}]", flush=True)
    print(f"  plaquette after sweeps 10, 20, 30: {plaq[itrj == 10, 0]}, {plaq[itrj == 20, 0]}, "
          f"{plaq[itrj == 30, 0]}; mean of sweeps 31-60 {mean:.6f} (JAX 12^4 chain {ref})",
          flush=True)
    STATE["checks"] += 1
    if len(window) != 30 or abs(mean - ref) > 0.0025:
        fail(f"the mean plaquette of sweeps 31-60, {mean}, is not within {ref} +- 0.0025")


# The improved action of phases 20 and 21: Iwasaki at beta_I = 2.6 in the reference's
# convention (the plaquette at c0 beta_I, the 1x2 rectangles through couplinglist at
# c1 beta_I, c0 = 3.648, c1 = -0.331), Wilson fermions at kappa 0.12 (< 1/8: D stays
# diagonally dominant on any unitary links) on 2 plaquette stout layers of rho 0.1,
# Omelyan with Sexton-Weingarten nsw 4, 5 steps of 0.04
IWASAKI = dict(beta=3.648 * 2.6, couplinglist=["rectangular"], couplingcoeff=[-0.331 * 2.6])
IMPROVED = dict(**IWASAKI, Dirac_operator="Wilson", hop=0.12, smearing_for_fermion="stout",
                stout_numlayers=2, stout_rho=[0.1], stout_loops=["plaquette"], MDscheme="Omelyan",
                SextonWeingargten=True, N_SextonWeingargten=4, MDsteps=5, dtau=0.04)


def phase_improved_agreement(torch):
    print("== 20. 4^4 complex128 improved actions: general gauge actions, stout smearing and the "
          "Sexton-Weingarten integrators, card against CPU and kernel path against plain path",
          flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga, wilsonline
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import build_gauge_action
    from latticeqcd_torch.updates.heatbath import Heatbath
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat = (4, 4, 4, 4)
    bar = BARS["complex128"]
    u = fields.hot_start(lat, 3, seed=60, dtype=torch.complex128, device="cpu")
    ug = u.to(dev)
    actions = {
        "Iwasaki": IWASAKI,
        "chair": dict(beta=5.5, couplinglist=["chair"], couplingcoeff=[-0.1]),
        "polyakov_t": dict(beta=5.5, couplinglist=["polyakov_t"], couplingcoeff=[0.2]),
        "coupling_loops": dict(beta=5.5, couplingcoeff=[0.3],
                               coupling_loops=[[[(0, 1), (1, 2), (0, -1), (1, -2)]]]),
    }
    for name, kw in actions.items():
        act = build_gauge_action(Params(L=lat, **kw))
        check(f"{name} staples, card vs CPU",
              max(maxdiff(ga.staples(act, ug, mu).cpu(), ga.staples(act, u, mu)) for mu in range(4)),
              bar)
        check(f"{name} force, card vs CPU", maxdiff(ga.force(act, ug).cpu(), ga.force(act, u)), bar)
    wilson = ga.wilson_gauge_action(3, 5.7)
    generic = ga.GaugeAction(3, wilson.terms)  # plaq_coeff 0: the generic path derivative
    check("generic plaquette staple vs the fused _plaquette_staple, card",
          max(maxdiff(ga.staples(generic, ug, mu), ga.staples(wilson, ug, mu)) for mu in range(4)),
          bar)
    net = stout_stack([0.1, 0.1], loop_names=("plaquette",))
    check("2-layer stout smear, card vs CPU", maxdiff(net.smear(ug).cpu(), net.smear(u)), bar)

    gen = torch.Generator(device=dev).manual_seed(61)
    forces = [("Wilson", WilsonFermiAction(WilsonDirac(kappa=0.12), eps_cg=1e-22))]
    forces += [(f"staggered Nf={nf}", StaggeredFermiAction(
        StaggeredDirac(mass=MASS, lattice=lat), nf=nf, eps_cg=1e-22)) for nf in (4, 2)]
    for name, fa in forces:
        _, phi = fa.sample_pseudofermion(net.smear(ug), generator=gen)
        before = _launch_counts()
        f_k = fa.force(ug, phi, smear_fn=net.smear)
        launched = _launch_counts() != before
        with _plain_kernels():
            f_p = fa.force(ug, phi, smear_fn=net.smear)
        if not launched:
            fail(f"the smeared {name} force launched no kernel")
        check(f"smeared {name} force, kernel vs plain (relative)",
              maxdiff(f_k, f_p) / float(f_p.abs().max()), 1e-10)

    # trajectories: scenario 7's action, the phase-21 action, staggered Nf=2 with stout + QPQ-SW
    # (scenario 7 takes 20 steps of 0.05; 5 of them hold the same kernels, 14 s less)
    scenario7 = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.05, md_steps=5,
                    sexton_weingarten=True, nsw=10,
                    fermi_action=WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19))
    _trajectory_pair(torch, "scenario 7 (Wilson, QPQ-SW nsw 10)", scenario7, ug, 62)
    iwasaki = build_gauge_action(Params(L=lat, **IWASAKI))
    fa = WilsonFermiAction(WilsonDirac(kappa=0.12), eps_cg=1e-19)
    improved = HMC(action=iwasaki, dtau=0.04, md_steps=5, scheme="Omelyan",
                   sexton_weingarten=True, nsw=4, fermi_action=fa, smearing=net)
    _trajectory_pair(torch, "Iwasaki + 2 stout + Omelyan-SW", improved, ug, 63)
    stag = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=4,
               sexton_weingarten=True, nsw=2, smearing=stout_stack([0.1]),
               fermi_action=StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=2,
                                                 eps_cg=1e-19))
    _trajectory_pair(torch, "staggered Nf=2 + 1 stout + QPQ-SW", stag, ug, 64)

    # reversibility of the phase-21 action: integrate 2 steps, flip the momenta, integrate back
    draws = Draws.sample(improved, ug, torch.Generator(device=dev).manual_seed(65))
    _, phi = fa.sample_pseudofermion(net.smear(ug), normals=draws.xi)
    kw = dict(force_fermion=lambda uu: fa.force(uu, phi, smear_fn=net.smear), scheme="Omelyan",
              sexton_weingarten=True, nsw=4)
    force_g = lambda uu: ga.force(iwasaki, uu)
    u1, h1 = integrators.run_md(ug, draws.momentum(ug), force_g, 0.04, 2, **kw)
    u2, _ = integrators.run_md(u1, -h1, force_g, 0.04, 2, **kw)
    check("Iwasaki + 2 stout + Omelyan-SW MD reversibility max|dU|", maxdiff(u2, ug), 1e-8)

    # a plaquette + rectangle action's overrelaxation and heatbath on 3^4: 3^4 colours of one
    # site (4^4's 256 colours took 80 s of the phase, launch-bound on both sides)
    for nc, beta in ((2, 1.9), (3, 5.7)):
        act = ga.general_gauge_action(nc, [beta, -beta / 20.0],
                                      [wilsonline.make_loops_fromname("plaquette"),
                                       wilsonline.make_loops_fromname("rectangular")])
        hb = Heatbath(action=act)
        w = _warm_links(torch, (3, 3, 3, 3), nc, 66 + nc, "cpu")
        cpu, gpu = hb.overrelax(w), hb.overrelax(w.to(dev))
        check(f"rectangle-action overrelaxation SU({nc}), card vs CPU", maxdiff(gpu.cpu(), cpu), bar)
        s0, s1 = float(ga.action_value(act, w.to(dev))), float(ga.action_value(act, gpu))
        check(f"rectangle-action overrelaxation SU({nc}) total action, relative change",
              abs(s1 - s0) / max(1.0, abs(s0)), 1e-8)
        cpu = hb.sweep(w, uniforms=_HostUniforms(torch, 8))
        gpu = hb.sweep(w.to(dev), uniforms=_HostUniforms(torch, 8))
        check(f"rectangle-action heatbath sweep SU({nc}) from host uniforms, card vs CPU",
              maxdiff(gpu.cpu(), cpu), bar)


def phase_improved_path(torch):
    print("== 21. improved-action path: run_lqcd_params, 16^3x32 Iwasaki + 2-flavour Wilson on 2 "
          "stout layers, Omelyan with Sexton-Weingarten, complex64, 2 trajectories", flush=True)
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops import sun
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import build_gauge_action, build_smearing
    from latticeqcd_torch.updates.hmc import HMC

    maxcg = 3000
    p = Params(L=MAIN, NC=3, initial="hot", update_method="HMC", quench=False, r=1.0,
               BoundaryCondition=(1, 1, 1, -1), Nsteps=2, eps=1e-12, MaxCGstep=maxcg,
               randomseed=3, verboselevel=2,
               measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}], **IMPROVED)
    last = {}
    step = HMC.step

    def stepped(self, u, generator=None, draws=None):
        out = step(self, u, generator, draws)
        last["u"] = out[0]
        return out

    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wk.launches = 0
    wk.site_launches.update(full=0, packed=0)
    with mock.patch.object(HMC, "step", stepped):
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                               history=history)
    torch.cuda.synchronize()
    launched, site = wk.launches, dict(wk.site_launches)
    peak = torch.cuda.max_memory_allocated()
    STATE["launches"].setdefault("wilson_hop_packed", {})["improved-action path"] = launched
    for rec in history:
        iters = [c["iterations"] for c in rec["cg"]]
        worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  {len(iters)} solves, CG "
              f"iterations per solve {statistics.mean(iters):.1f} (most {max(iters)})  dH "
              f"{rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  worst "
              f"verified residual/target {worst:.3g}  [{STATE['smi']}]", flush=True)
        STATE["checks"] += 1
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if worst > 1.0 or max(iters) >= maxcg:
            fail("a CG reached MaxCGstep or returned a verified residual above its target")
        if not 0.0 < rec["plaq"] < 1.0:
            fail(f"plaquette {rec['plaq']} outside (0, 1)")
    defect = float(sun.unitarity_defect(last["u"]))
    print(f"  final plaquette {plaq:.8f}, unitarity defect {defect:.3e}; launches on the path: "
          f"wilson_hop_packed {launched} ({launched / len(history):.0f} per trajectory), "
          f"wilson_hop {site}; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    STATE["checks"] += 1
    if defect > 1e-4:
        fail(f"unitarity defect {defect} after the run exceeds 1e-4")
    if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"plaquette {plaq} outside (0, 1)")
    if launched == 0:
        fail("the improved-action path launched wilson_hop_packed no time")
    if site["packed"]:
        fail("the improved-action path launched wilson_hop's packed mode")

    # B4's inputs on the run's links: the generic (Iwasaki) force against the fused (Wilson)
    # one, and one smearing forward + backward (a vector-Jacobian product, as in the force)
    u = last["u"]
    iwasaki, wilson = build_gauge_action(p), ga.wilson_gauge_action(3, p.beta)
    net = build_smearing(p)
    cot = sun.random_hermitian_momentum(u.shape[:-2], 3, dtype=u.dtype, device=u.device,
                                        generator=torch.Generator(device=u.device).manual_seed(4))

    def smear_vjp():
        uu = u.detach().requires_grad_(True)
        with torch.enable_grad():
            torch.autograd.grad(net.smear(uu), uu, grad_outputs=cot)

    ms = {name: _time_eager(torch, fn, n=10, warm=2) for name, fn in (
        ("Iwasaki force", lambda: ga.force(iwasaki, u)),
        ("Wilson force", lambda: ga.force(wilson, u)),
        ("stout smear forward + backward", smear_vjp))}
    print(f"  16^3x32 complex64, median of 10 eager calls between CUDA events: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" (Iwasaki/Wilson {ms['Iwasaki force'] / ms['Wilson force']:.2f}x)  [{STATE['smi']}]",
          flush=True)


# phase 22/23's domain-wall action: the reference's sign convention (diagonal 4r + M), so
# M = -1.8 is M5 = 1.8 in the usual one
DW_M5, DW_L5, DW_MASS = -1.8, 16, 0.04


def _rel(a, b) -> float:
    """max|a - b| / max|b| of two tensors or arrays (numbers on the host)."""
    import numpy as np

    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def phase_domainwall_agreement(torch):
    print("== 22. 4x4x2x2 L5=4 domain wall: the card against the CPU and the kernel path "
          "against the plain path", flush=True)
    import numpy as np

    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.measurements import fermionic
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from latticeqcd_torch.ops.fermion_action import DomainwallFermiAction
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    lat, odd, l5 = (4, 4, 2, 2), (3, 4, 2, 2), 4
    d = DomainwallDirac(mass=0.3, m5=DW_M5, l5=l5)
    rng = np.random.default_rng(70)

    def spinor(shape, dtype):
        re, im = rng.standard_normal(shape), rng.standard_normal(shape)
        return torch.from_numpy(re + 1j * im).to(dtype)

    def counted(fn, counter, want):
        """fn() on the card, checking that it launched `want` kernels of its module."""
        mod = wk if counter == "wilson_hop_packed" else ww
        before = mod.launches
        out = fn()
        torch.cuda.synchronize()
        if mod.launches - before != want:
            fail(f"{counter} launched {mod.launches - before} times, not {want}")
        return out

    def same(label, got, ref, kernel):
        """complex128: max|diff| at 1e-12, counted toward the kernel's error; complex64:
        relative to the largest entry at 1e-5 (D^dag D reaches |100|, where float32 rounding
        alone is 1e-5)."""
        if got.dtype == torch.complex128:
            check(label, maxdiff(got.cpu(), ref), BARS["complex128"], kernel)
        else:
            check(f"{label} (relative)", _rel(got, ref), BARS["complex64"])

    for dtype in (torch.complex128, torch.complex64):
        name = str(dtype).split(".")[1]
        for lt in (lat, odd):
            tag = f"{'x'.join(map(str, lt))} L5={l5} {name}"
            u = apply_boundary_phases(fields.hot_start(lt, 3, seed=71, dtype=dtype, device="cpu"))
            ug = u.to(dev)
            psi = spinor((l5,) + lt + (4, 3), dtype)
            for label, fn, n in (("D", d.apply, l5), ("D^dag", d.apply_dagger, l5),
                                 ("D^dag D", d.apply_ddag_d, 2 * l5)):
                got = counted(lambda: fn(ug, psi.to(dev)), "wilson_window", n)
                same(f"domain-wall {label} {tag}, card vs CPU", got, fn(u, psi), "wilson_window")
            if lt != lat:
                continue
            ueo = d.packed_links(u)
            geo = tuple(t.to(dev) for t in ueo)
            phi = spinor((l5, lt[0] // 2) + lt[1:] + (4, 3), dtype)
            for dag in (False, True):
                got = counted(lambda: d.apply_schur(geo, phi.to(dev), dag=dag), "wilson_hop_packed",
                              2 * l5)
                same(f"domain-wall Shat{'^dag' if dag else ''} {tag}, card vs CPU", got,
                     d.apply_schur(ueo, phi, dag=dag), "wilson_hop_packed")
            got = counted(lambda: d.apply_schur_ddag_d(geo, phi.to(dev)), "wilson_hop_packed",
                          4 * l5)
            same(f"domain-wall Shat^dag Shat {tag}, card vs CPU", got,
                 d.apply_schur_ddag_d(ueo, phi), "wilson_hop_packed")

    # no fall-back to the plain version on the card: NC != 3 raises, in the r mode too
    su2 = fields.hot_start(lat, 2, seed=71, dtype=torch.complex128, device=dev)
    x = torch.zeros((l5,) + lat + (4, 2), dtype=su2.dtype, device=dev)
    for label, op in (("NC = 2 at r = 0.7", DomainwallDirac(0.3, DW_M5, l5, r=0.7)),
                      ("NC = 2", d)):
        try:
            op.apply_ddag_d(su2, x)
        except ValueError as exc:
            print(f"  ok   domain wall with {label} on the card raises: {exc}", flush=True)
        else:
            fail(f"domain wall with {label} ran on the card")
        STATE["checks"] += 1

    # the action, the force with and without a stout layer, and the measurements, card
    # against CPU in complex128 (solves to relative |r|^2 1e-24: the bar compares the kernels,
    # not the solvers' stopping points)
    fa = DomainwallFermiAction(d, eps_cg=1e-24)
    net = stout_stack([0.1])
    for lt in (lat, odd):
        tag = f"{'x'.join(map(str, lt))} L5={l5} complex128"
        u = fields.hot_start(lt, 3, seed=72, dtype=torch.complex128, device="cpu")
        ug = u.to(dev)
        _, phi = fa.sample_pseudofermion(u, generator=torch.Generator().manual_seed(73))
        check(f"domain-wall action {tag}, card vs CPU (relative)",
              _rel(fa.action(ug, phi.to(dev)), fa.action(u, phi)), 1e-10)
        for layers, smear in ((0, None), (1, net.smear)):
            f_c = fa.force(u, phi, smear_fn=smear)
            f_g = fa.force(ug, phi.to(dev), smear_fn=smear)
            check(f"domain-wall force, {layers} stout layer(s), {tag}, card vs CPU (relative)",
                  _rel(f_g, f_c), 1e-10)
        up, upg = apply_boundary_phases(u), apply_boundary_phases(ug)
        b4 = spinor((2,) + lt + (4, 3), torch.complex128)
        q_c = fermionic._dw_effective_propagator_multi(d, up, b4, 1e-24, 3000)
        q_g = fermionic._dw_effective_propagator_multi(d, upg, b4.to(dev), 1e-24, 3000)
        check(f"domain-wall effective propagator {tag}, card vs CPU (relative)", _rel(q_g, q_c),
              1e-10)
        draws = rng.integers(0, 4, (2,) + lt + (4, 3))
        check(f"domain-wall pbp per noise {tag}, card vs CPU (relative)",
              _rel(fermionic.chiral_condensate(ug, d, nr=2, draws=draws, eps=1e-24)[1],
                   fermionic.chiral_condensate(u, d, nr=2, draws=draws, eps=1e-24)[1]), 1e-10)
        v0 = spinor((l5,) + lt + (4, 3), torch.complex128)
        before = ww.launches
        s_g = fermionic.dirac_low_spectrum(ug, d, k=3, m=24, v0=v0.to(dev))
        if ww.launches - before != 24 * 2 * l5:
            fail(f"the domain-wall spectrum launched wilson_window {ww.launches - before} times")
        check(f"domain-wall low spectrum {tag}, card vs CPU (relative)",
              _rel(s_g, fermionic.dirac_low_spectrum(u, d, k=3, m=24, v0=v0)), 1e-10)

    # one trajectory through the kernels and one through their plain versions, and MD
    # reversibility, 2 MD steps each (every plain slice hop costs milliseconds)
    ug = fields.hot_start(lat, 3, seed=74, dtype=torch.complex128, device=dev)
    fa = DomainwallFermiAction(d, eps_cg=1e-22)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2, fermi_action=fa)
    _trajectory_pair(torch, "domain wall m=0.3 M=-1.8 L5=4", hmc, ug, 75)
    draws = Draws.sample(hmc, ug, torch.Generator(device=dev).manual_seed(76))
    _, phi = fa.sample_pseudofermion(ug, normals=draws.xi)
    force_f = lambda uu: fa.force(uu, phi)
    force_g = lambda uu: ga.force(hmc.action, uu)
    u1, h1 = integrators.run_md(ug, draws.momentum(ug), force_g, 0.1, 2, force_fermion=force_f)
    u2, _ = integrators.run_md(u1, -h1, force_g, 0.1, 2, force_fermion=force_f)
    check("domain-wall MD reversibility max|dU|", maxdiff(u2, ug), 1e-8)


def phase_domainwall_path(torch):
    print("== 23. domain-wall path: run_lqcd_params, 16^3x32 two-flavour Shamir domain wall "
          f"(M = {DW_M5}, L5 = {DW_L5}, m = {DW_MASS}), complex64, 1 trajectory with the "
          "domain-wall measurements at itrj 0", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops import sun
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from latticeqcd_torch.ops.fermion_action import DomainwallFermiAction
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.hmc import HMC

    maxcg = 3000
    dw = {"Dirac_operator": "Domainwall", "Domainwall_m": DW_MASS, "Domainwall_M": DW_M5,
          "Domainwall_L5": DW_L5}
    methods = [
        {"methodname": "Pion_correlator", "fermion_parameters": dw, "MaxCGstep": maxcg},
        {"methodname": "Chiral_condensate", "fermion_parameters": dw, "Nr": 10,
         "MaxCGstep": maxcg},
        {"methodname": "Dirac_spectrum", "fermion_parameters": dw, "Neig": 8, "Nlanczos": 48},
    ]
    p = Params(
        L=MAIN, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=False,
        Dirac_operator="Domainwall", Domainwall_m=DW_MASS, Domainwall_M=DW_M5,
        Domainwall_L5=DW_L5, BoundaryCondition=(1, 1, 1, -1), QPQ=True, dtau=0.02, MDsteps=10,
        Nsteps=1, eps=1e-12, MaxCGstep=maxcg, randomseed=3, verboselevel=1,
        # measured at itrj 0 only: a round of the three methods at L5 16 takes about 25 s
        measurement_methods=[{**m, "measure_every": 2} for m in methods],
    )
    records, samples, last = [], [], {}
    step, sample = HMC.step, DomainwallFermiAction.sample_pseudofermion

    def stepped(self, u, generator=None, draws=None):
        out = step(self, u, generator, draws)
        last["u"] = out[0]
        return out

    def sampled(self, u, generator=None, normals=None, log=None):
        log = [] if log is None else log
        out = sample(self, u, generator, normals, log=log)
        samples.extend(log)  # the pseudofermion's PV solve, which HMC.step does not log
        return out

    def timed(cls):
        measure = cls.measure

        def wrapper(self, u, itrj, additional_string=""):
            torch.cuda.synchronize()
            before = _launch_counts()
            t0 = time.time()
            line = measure(self, u, itrj, additional_string)
            torch.cuda.synchronize()
            records.append({"method": self.name, "itrj": itrj, "seconds": time.time() - t0,
                            "value": self.value, "solves": self.solves,
                            "launches": {k: v - before[k] for k, v in _launch_counts().items()}})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ww.launches = wk.launches = sk.launches = sk.w_launches = sk.fused_launches = 0
    wk.site_launches.update(full=0, packed=0)
    with mock.patch.object(HMC, "step", stepped), \
            mock.patch.object(DomainwallFermiAction, "sample_pseudofermion", sampled), \
            timed(scheduler.PionCorrelatorMeasurement), \
            timed(scheduler.ChiralCondensateMeasurement), \
            timed(scheduler.DiracSpectrumMeasurement):
        t0 = time.time()
        plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                               history=history)
    torch.cuda.synchronize()
    total = time.time() - t0
    counts, site = _launch_counts(), dict(wk.site_launches)
    peak = torch.cuda.max_memory_allocated()
    for name in ("wilson_hop_packed", "wilson_window"):
        STATE["launches"].setdefault(name, {})["domain-wall path"] = counts[name]
    measured = {k: sum(r["launches"][k] for r in records) for k in counts}

    for rec in history:
        iters = [c["iterations"] for c in rec["cg"]]
        worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
        print(f"  trajectory {rec['itrj']}: {rec['seconds']:.3f} s  {len(iters)} solves, CG "
              f"iterations per solve {statistics.mean(iters):.1f} (most {max(iters)})  dH "
              f"{rec['dH']:.6f}  accepted {rec['accepted']}  plaquette {rec['plaq']:.8f}  worst "
              f"verified residual/target {worst:.3g}  [{STATE['smi']}]", flush=True)
        STATE["checks"] += 1
        if not math.isfinite(rec["dH"]):
            fail(f"non-finite dH {rec['dH']}")
        if worst > 1.0 or max(iters) >= maxcg:
            fail("a CG reached MaxCGstep or returned a verified residual above its target")
        if not 0.0 < rec["plaq"] < 1.0:
            fail(f"plaquette {rec['plaq']} outside (0, 1)")
    print(f"  pseudofermion (Pauli-Villars) solves: iterations "
          f"{[c['iterations'] for c in samples]}", flush=True)
    if any(c["iterations"] >= maxcg or c["rsq"] > c["target"] for c in samples):
        fail("a pseudofermion solve reached MaxCGstep or missed its target")
    for rec in records:
        value, solves = rec["value"], rec["solves"] or []
        iters = sum(c["iterations"] for c in solves)
        if rec["method"] == "Dirac_spectrum":
            shown = " ".join(f"{v:.6g}" for v in value)
            work = f"{len(value)} Ritz values from 48 Lanczos steps"
        else:
            work = (f"CG iterations {iters} in {len(solves)} solve(s) of "
                    f"{sum(c.get('rhs', 1) for c in solves)} RHS")
            if rec["method"] == "Chiral_condensate":
                shown = f"pbp {value[0]:.8g}"
                value = [value[0]] + list(value[1])
            else:
                shown = "C(t) " + " ".join(f"{v:.4g}" for v in value[:4]) + " ..."
        print(f"  itrj {rec['itrj']} {rec['method']}: {rec['seconds']:.3f} s  {work}  launches "
              f"{rec['launches']}  {shown}  [{STATE['smi']}]", flush=True)
        STATE["checks"] += 1
        if not np.all(np.isfinite(np.asarray(value, dtype=np.float64))):
            fail(f"{rec['method']} gave a value that is not finite")
        if any(c["iterations"] >= maxcg or c["rsq"] > c["target"] for c in solves):
            fail(f"a {rec['method']} solve reached MaxCGstep or missed its target")
        if rec["method"] == "Pion_correlator" and not np.all(np.asarray(value) > 0):
            fail("the domain-wall pion correlator is not positive")
        if rec["method"] == "Dirac_spectrum" and not (
                np.all(np.diff(value) >= 0) and np.all(np.asarray(value) > 0)):
            fail("the domain-wall low eigenvalues are not ascending and positive")
    if sorted((r["method"], r["itrj"]) for r in records) != sorted(
            (m["methodname"], 0) for m in methods):
        fail("the domain-wall path did not run every method at itrj 0 (and only there)")
    defect = float(sun.unitarity_defect(last["u"]))
    traj = counts["wilson_hop_packed"] - measured["wilson_hop_packed"]
    print(f"  run_lqcd_params {total:.3f} s, final plaquette {plaq:.8f}, unitarity defect "
          f"{defect:.3e}; launches on the path {counts} (trajectories: wilson_hop_packed "
          f"{traj / len(history):.0f} per trajectory; measurements {measured}), wilson_hop "
          f"{site}; torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB (a 5D c64 field "
          f"{DW_L5 * math.prod(MAIN) * 96 / 1e6:.0f} MB, the 48-vector Lanczos basis "
          f"{48 * DW_L5 * math.prod(MAIN) * 96 / 1e9:.2f} GB)  [{STATE['smi']}]", flush=True)
    STATE["checks"] += 1
    if defect > 1e-4:
        fail(f"unitarity defect {defect} after the run exceeds 1e-4")
    if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
        fail(f"plaquette {plaq} outside (0, 1)")
    for name in ("wilson_hop_packed", "wilson_window"):
        if counts[name] == 0:
            fail(f"the domain-wall path launched {name} no time")
    if site["packed"]:
        fail("the domain-wall path launched wilson_hop's packed mode")

    # on the run's links: one Shat^dag Shat against the bounds of the slice loop and of a hop
    # with a fifth-dimension axis, and one domain-wall force with its solve
    u = last["u"]
    fa = DomainwallFermiAction(scheduler.build_dirac_from_params(dw, MAIN), eps_cg=p.eps,
                               max_cg=maxcg)
    d = fa.dirac
    ueo = d.packed_links(apply_boundary_phases(u, d.bc))
    gen = torch.Generator(device=u.device).manual_seed(5)
    x = torch.randn(fa.noise_shape(u), dtype=u.dtype, device=u.device, generator=gen)
    before = wk.launches
    d.apply_schur_ddag_d(ueo, x)
    torch.cuda.synchronize()
    per_op = wk.launches - before
    if per_op != 4 * DW_L5:
        fail(f"one Shat^dag Shat launched wilson_hop_packed {per_op} times, not 4 L5 = {4 * DW_L5}")
    vol_half = math.prod(MAIN) // 2
    loop_bytes = 4 * vol_half * DW_L5 * 768
    axis_bytes = 4 * vol_half * (576 + DW_L5 * 192)
    eager = _time_eager(torch, lambda: d.apply_schur_ddag_d(ueo, x), n=10, warm=2)
    graph = _time_device(torch, lambda: d.apply_schur_ddag_d(ueo, x), reps=4, n=10)
    print(f"  one Shat^dag Shat (16^3x32, L5 = {DW_L5}, complex64, {per_op} wilson_hop_packed "
          f"launches): {eager:.3f} ms eager, {graph:.3f} ms device (CUDA graph); bound "
          f"{loop_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms for the slice loop's "
          f"{loop_bytes / 1e9:.2f} GB, {axis_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms for a hop "
          f"with a fifth-dimension axis ({axis_bytes / 1e9:.2f} GB)  [{STATE['smi']}]", flush=True)
    _, phi = fa.sample_pseudofermion(u, generator=gen)
    log = []
    force_ms = _time_eager(torch, lambda: fa.force_with_guess(u, phi, None, log=log), n=3, warm=1)
    print(f"  one domain-wall force (its solve from zero, {log[-1]['iterations']} CG iterations, "
          f"and the backward through the hops): {force_ms:.1f} ms eager  [{STATE['smi']}]",
          flush=True)


# ------------------------------------------------------------------ self-learning updaters


def _card_draws(draws):
    """hmc.Draws drawn on the host, moved to the card (the same numbers on both devices)."""
    from latticeqcd_torch.updates.hmc import Draws

    move = lambda pair: None if pair is None else tuple(x.cuda() for x in pair)  # noqa: E731
    return Draws(move(draws.mom), move(draws.xi), draws.uniform)


def _beta_rel(a, b) -> float:
    """max|a - b| / max|b| of two beta_eff tuples."""
    return max(abs(x - y) for x, y in zip(a, b)) / max(abs(y) for y in b)


def _check_steps(label, st_a, u_a, st_b, u_b, what):
    check(f"{label} {what} |ddH|", abs(st_a["dH"] - st_b["dH"]), 1e-9)
    check(f"{label} {what} max|dU|", maxdiff(u_a.cpu(), u_b.cpu()), 1e-10)
    rel = _beta_rel(st_a["beta_eff"], st_b["beta_eff"])
    print(f"    beta_eff {st_a['beta_eff']} / {st_b['beta_eff']}: relative difference {rel:.3e}",
          flush=True)
    check(f"{label} {what} beta_eff (relative)", rel, 1e-7)
    if st_a["accepted"] != st_b["accepted"]:
        fail(f"{label}: {what} disagree on accept")


def _sl_chain(torch, label, make, u, nsteps, seed, kernels=True, cpu=True):
    """nsteps of three updaters made alike (the card through the kernels, the card through
    their plain versions, the CPU) from the same host draws, each step checked; SLHMC takes
    hmc.Draws, SLMC host uniforms (_HostUniforms) and a Metropolis uniform. Without
    ``kernels`` (a quenched updater, which launches none) the plain path is left out, without
    ``cpu`` the CPU path. Returns the kernel launches of the card's kernel path."""
    import numpy as np

    from latticeqcd_torch.updates.hmc import Draws
    from latticeqcd_torch.updates.slhmc import SLHMC

    ups = {"card": make(), "plain": make(), "cpu": make()}
    us = {"card": u.cuda(), "plain": u.cuda(), "cpu": u.cpu()}
    launched = {}
    for k in range(nsteps):
        sts = {}
        for path in ("card",) + (("plain",) if kernels else ()) + (("cpu",) if cpu else ()):
            up = ups[path]
            if isinstance(up, SLHMC):
                d = Draws.sample(up, us["cpu"], torch.Generator().manual_seed(seed + k))
                kw = dict(draws=d if path == "cpu" else _card_draws(d))
            else:
                kw = dict(uniforms=_HostUniforms(torch, seed + k),
                          uniform=float(np.random.default_rng([seed, k]).random()))
            before = _launch_counts()
            t0 = time.time()
            if path == "plain":
                with _plain_kernels():
                    us[path], sts[path] = up.step(us[path], **kw)
            else:
                us[path], sts[path] = up.step(us[path], **kw)
            seconds = time.time() - t0
            after = _launch_counts()
            diff = {n: after[n] - before[n] for n in after if after[n] != before[n]}
            if path == "card":
                for n, v in diff.items():
                    launched[n] = launched.get(n, 0) + v
            elif diff:
                fail(f"{label}: the {path} path launched a kernel: {diff}")
            st = sts[path]
            print(f"  {label} step {k + 1} {path}: {seconds:.2f} s  dH {st['dH']:.10f}  accepted "
                  f"{st['accepted']}  beta_eff {st['beta_eff']}"
                  + (f"  launches {diff}" if path == "card" else ""), flush=True)
        if cpu:
            _check_steps(label, sts["card"], us["card"], sts["cpu"], us["cpu"], "card vs CPU")
        if kernels:
            _check_steps(label, sts["card"], us["card"], sts["plain"], us["plain"],
                         "kernel vs plain")
    if kernels and not launched:
        fail(f"{label}: the card's kernel path launched no kernel")
    return launched


def phase_selflearning_agreement(torch):
    print("== 24. 4^4 complex128 self-learning updaters: the card against the CPU and the kernel "
          "path against the plain path", flush=True)
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.system.universe import build_gauge_action
    from latticeqcd_torch.updates.slhmc import (SLHMC, SLMC, dense_logdet_fermi_action,
                                                integrated_hb, integrated_hmc)

    lat = (4, 4, 4, 4)
    hot = fields.hot_start(lat, 3, seed=70, dtype=torch.complex128, device="cpu")
    wilson57 = ga.wilson_gauge_action(3, 5.7)

    _sl_chain(torch, "quenched SLHMC (beta 5.7 from beta_eff 3.0)",
              lambda: SLHMC(wilson57, dtau=0.01, md_steps=10, beta_eff=3.0, firstlearn=1),
              hot, 5, 71, kernels=False)
    fw = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-22)
    _sl_chain(torch, "Wilson SLHMC",
              lambda: SLHMC(wilson57, dtau=0.02, md_steps=10, fermi_action=fw, beta_eff=5.5),
              hot, 1, 72)
    fs = StaggeredFermiAction(StaggeredDirac(mass=1.0, lattice=lat), nf=4, eps_cg=1e-22)
    _sl_chain(torch, "staggered Nf=4 SLHMC",
              lambda: SLHMC(wilson57, dtau=0.02, md_steps=10, fermi_action=fs, beta_eff=5.5),
              hot, 1, 73)
    # SLMC on warm links (a heatbath sweep on Haar-random links amplifies rounding), on 3^4:
    # the rectangle basis colours 3^4 by 81 colours of one site (4^4's 256 colours took 42 s,
    # launch-bound on both sides, as phase 20's sweeps)
    rect_lat = (3, 3, 3, 3)
    iwasaki = build_gauge_action(Params(L=rect_lat, **IWASAKI))
    _sl_chain(torch, "SLMC, plaquette + rectangle basis on 3^4 (Iwasaki from beta_eff [9, 0])",
              lambda: SLMC(iwasaki, beta_eff=[9.0, 0.0], firstlearn=2,
                           couplinglist=("plaquette", "rectangular")),
              _warm_links(torch, rect_lat, 3, 74, "cpu"), 1, 75, kernels=False)

    # the dense log det, Wilson (3072 wilson_window launches) and staggered (384 staggered_w)
    cases = [("Wilson", WilsonDirac(kappa=KAPPA), lat + (4, 3), 1.0, 3072),
             ("staggered", StaggeredDirac(mass=1.0, lattice=lat), lat + (3,), 0.5, 384)]
    for name, dirac, shape, weight, ncols in cases:
        sf = dense_logdet_fermi_action(dirac, shape, weight)
        up = apply_boundary_phases(hot)
        t0 = time.time()
        cpu = float(sf(up))
        t_cpu = time.time() - t0
        before = _launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        card = float(sf(up.cuda()))
        torch.cuda.synchronize()
        t_card = time.time() - t0
        launched = {n: v - before[n] for n, v in _launch_counts().items() if v != before[n]}
        with _plain_kernels():
            plain = float(sf(up.cuda()))
        print(f"  {name} log det (dim {math.prod(shape)}): S_f card {card:.15g}, plain {plain:.15g}, "
              f"CPU {cpu:.15g}; {t_card:.3f} s on the card ({launched} launches), {t_cpu:.3f} s "
              f"on the CPU  [{STATE['smi']}]", flush=True)
        check(f"{name} log det, card vs CPU (relative)", abs(card - cpu) / abs(cpu), 1e-12)
        check(f"{name} log det, kernel vs plain (relative)", abs(card - plain) / abs(plain), 1e-12,
              kernel="wilson_window" if name == "Wilson" else "staggered_w")
        kernel = "wilson_window" if name == "Wilson" else "staggered_w"
        if launched != {kernel: ncols}:
            fail(f"the {name} log det launched {launched}, not {ncols} {kernel}")

    # the integrated updaters with the exact two-flavour Wilson determinant, one step each,
    # kernel path against plain path on 4x4x2x2 (dim 768: each plain step rebuilds the dense
    # determinant twice, 18 s a step at 4^4's dim 3072; the 4^4 determinant itself is held
    # card against CPU and kernel against plain just above)
    small = (4, 4, 2, 2)
    sfw = dense_logdet_fermi_action(WilsonDirac(kappa=KAPPA), small + (4, 3), 1.0)
    logdet = lambda uu: sfw(apply_boundary_phases(uu))  # noqa: E731
    _sl_chain(torch, "IntegratedHMC (Wilson, 4x4x2x2)",
              lambda: integrated_hmc(wilson57, dtau=0.02, md_steps=10, fermi_logdet=logdet),
              fields.hot_start(small, 3, seed=70, dtype=torch.complex128, device="cpu"), 1, 76,
              cpu=False)
    _sl_chain(torch, "IntegratedHB (Wilson, 4x4x2x2)",
              lambda: integrated_hb(wilson57, fermi_logdet=logdet),
              _warm_links(torch, small, 3, 77, "cpu"), 1, 78, cpu=False)


def phase_selflearning_path(torch):
    print("== 25. self-learning path: run_lqcd_params, 16^3x32 complex64 SLHMC with 2-flavour "
          "Wilson on a plaquette + rectangle basis and quenched SLMC, 4 steps each; the dense "
          "updaters at 4^4", flush=True)
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates import slhmc
    from latticeqcd_torch.updates.heatbath import Heatbath
    from latticeqcd_torch.updates.slhmc import SLHMC, SLMC

    maxcg = 3000
    base = dict(NC=3, initial="hot", BoundaryCondition=(1, 1, 1, -1), QPQ=True, dtau=0.02,
                MDsteps=10, Nsteps=4, eps=1e-12, MaxCGstep=maxcg, randomseed=3, verboselevel=2,
                measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}])
    last = {}

    def capture(cls):
        step = cls.step

        def stepped(self, u, generator=None, **kw):
            out = step(self, u, generator, **kw)
            last.update(up=self, u=out[0])
            return out

        return mock.patch.object(cls, "step", stepped)

    md_launches = []
    run_md = slhmc.integrators.run_md

    def counted_md(*args, **kw):
        before = wk.launches
        out = run_md(*args, **kw)
        md_launches.append(wk.launches - before)
        return out

    def run(p, dtype, patches):
        history = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ww.launches = wk.launches = sk.launches = sk.w_launches = sk.fused_launches = 0
        wk.site_launches.update(full=0, packed=0)
        from contextlib import ExitStack

        with ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            t0 = time.time()
            plaq = run_lqcd_params(p, make_dirs=False, dtype=dtype, device="cuda",
                                   history=history)
            torch.cuda.synchronize()
        counts = _launch_counts()
        print(f"  {p.update_method}: run_lqcd_params {time.time() - t0:.3f} s, final plaquette "
              f"{plaq:.8f}, launches {counts}, wilson_hop {dict(wk.site_launches)}, "
              f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
              f"  [{STATE['smi']}]", flush=True)
        STATE["checks"] += 1
        if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
            fail(f"{p.update_method}: plaquette {plaq} outside (0, 1)")
        if wk.site_launches["packed"] or sk.fused_launches:
            fail(f"{p.update_method}: a kernel off the paths was launched")
        return history, counts

    def show(history, unit):
        accepted = 0
        for rec in history:
            accepted += rec["accepted"]
            iters = sum(c["iterations"] for c in rec["cg"])
            print(f"  {unit} {rec['itrj']}: {rec['seconds']:.3f} s  dH {rec['dH']:.6f}  accepted "
                  f"{rec['accepted']}  beta_eff {rec['beta_eff']}  plaquette {rec['plaq']:.8f}"
                  + (f"  CG iterations {iters} in {len(rec['cg'])} solves" if rec["cg"] else "")
                  + f"  [{STATE['smi']}]", flush=True)
            STATE["checks"] += 1
            if not math.isfinite(rec["dH"]) or rec["beta_eff"] is None:
                fail(f"{unit} {rec['itrj']}: dH {rec['dH']} or beta_eff {rec['beta_eff']}")
            if any(c["iterations"] >= maxcg or c["rsq"] > c["target"] for c in rec["cg"]):
                fail("a CG reached MaxCGstep or missed its target")
        return accepted

    # SLHMC, two-flavour Wilson: the true action is Wilson's (couplinglist names the basis,
    # the empty couplingcoeff adds nothing to the action)
    p = Params(L=MAIN, beta=6.0, update_method="SLHMC", quench=False, Dirac_operator="Wilson",
               hop=KAPPA, r=1.0, couplinglist=["plaquette", "rectangular"], couplingcoeff=[],
               beta_eff=[6.0, 0.0], firstlearn=3, **base)
    history, counts = run(p, torch.complex64, [capture(SLHMC),
                                               mock.patch.object(slhmc.integrators, "run_md",
                                                                 counted_md)])
    accepted = show(history, "trajectory")
    hops = counts["wilson_hop_packed"]
    STATE["launches"].setdefault("wilson_hop_packed", {})["self-learning"] = hops
    print(f"  SLHMC acceptance {accepted}/{len(history)} (a gluonic basis leaves the fermion action "
          f"out of the MD, so a 16^3x32 trajectory is expected to reject); wilson_hop_packed "
          f"{hops / len(history):.0f} per trajectory, {sum(md_launches)} in the MD", flush=True)
    STATE["checks"] += 1
    if hops == 0 or sum(md_launches) != 0 or len(md_launches) != len(history):
        fail("SLHMC launched wilson_hop_packed no time, or launched it in the gluonic MD")
    up, u = last["up"], last["u"]
    coeffs = torch.as_tensor(up.beta_eff, dtype=torch.float32, device=u.device)
    force_ms = _time_eager(torch, lambda: up.basis.force(u, coeffs), n=5, warm=1)
    print(f"  one effective force (plaquette + rectangle basis, generic staples) {force_ms:.1f} ms: "
          f"{force_ms * p.MDsteps / 1e3:.2f} s of a trajectory's {p.MDsteps} QPQ forces  "
          f"[{STATE['smi']}]", flush=True)

    # quenched SLMC on the plaquette basis
    p = Params(L=MAIN, beta=6.0, update_method="SLMC", quench=True, beta_eff=5.5, firstlearn=1,
               **base)
    history, counts = run(p, torch.complex64, [capture(SLMC)])
    accepted = show(history, "step")
    print(f"  SLMC acceptance {accepted}/{len(history)}", flush=True)
    STATE["checks"] += 1
    if abs(history[-1]["beta_eff"][0] - 6.0) > 1e-3:
        fail(f"quenched SLMC did not learn beta = 6.0: {history[-1]['beta_eff']}")
    up, u = last["up"], last["u"]
    coeffs = torch.as_tensor(up.beta_eff, dtype=torch.float32, device=u.device)
    gen = torch.Generator(device=u.device).manual_seed(8)
    sweep_ms = _time_eager(torch, lambda: up.hb.sweep_with_coeffs(u, coeffs, generator=gen),
                           n=5, warm=1)
    plain = Heatbath(action=ga.wilson_gauge_action(3, 6.0))
    plain_ms = _time_eager(torch, lambda: plain.sweep(u, generator=gen), n=5, warm=1)
    print(f"  one coefficient sweep {sweep_ms:.1f} ms (generic plaquette staple), one plain "
          f"heatbath sweep {plain_ms:.1f} ms (fused staple)  [{STATE['smi']}]", flush=True)

    # the dense updaters, capped at dim 4608: 4^4 through run_lqcd_params; every log det must
    # launch its kernel once per column
    dense = []
    dense_fn = slhmc._dense

    def counted_dense(apply, shape, device):
        before = _launch_counts()
        out = dense_fn(apply, shape, device)
        dense.append((math.prod(shape), {n: v - before[n] for n, v in _launch_counts().items()
                                         if v != before[n]}))
        return out

    small = dict(base, L=(4, 4, 4, 4), Nsteps=2, beta=5.7)
    for p, kernel, key in (
            (Params(update_method="IntegratedHMC", quench=False, Dirac_operator="Wilson",
                    hop=KAPPA, r=1.0, **small), "wilson_window", "Wilson"),
            (Params(update_method="IntegratedHB", quench=False, Dirac_operator="Staggered",
                    mass=1.0, Nf=4, **small), "staggered_w", "staggered")):
        dense.clear()
        history, counts = run(p, torch.complex64,
                              [mock.patch.object(slhmc, "_dense", counted_dense)])
        show(history, "step")
        STATE["launches"].setdefault(kernel, {})["self-learning"] = counts[kernel]
        print(f"  {key} log dets: {len(dense)}, launches each {[d[1] for d in dense]}", flush=True)
        STATE["checks"] += 1
        if len(dense) != 2 * len(history) or any(d[1] != {kernel: d[0]} for d in dense):
            fail(f"a {key} log det did not launch {kernel} once per column: {dense}")


# ------------------------------------------------------------------ clover and Hasenbusch

# the two-flavour O(a)-improved point of the CLS Nf = 2 ensembles: beta 5.3 with ALPHA's
# non-perturbative csw (Fritzsch et al., Nucl. Phys. B865 (2012) 397; E5 runs it on 64x32^3)
CLOVER_BETA, CLOVER_KAPPA, CLOVER_CSW = 5.3, 0.13625, 1.90952


def phase_clover_agreement(torch):
    print("== 26. clover and Hasenbusch at 4^4, 4x2x4x2 and 4^3x8 complex128: the card against "
          "the CPU and the kernel path against the plain path", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import fermionic
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases, gaussian_spinor
    from latticeqcd_torch.ops.fermion_action import HasenbuschWilsonFermiAction, WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    dev = torch.device("cuda")
    c128 = torch.complex128
    bar = BARS["complex128"]
    d = WilsonDirac(kappa=CLOVER_KAPPA, csw=CLOVER_CSW)

    def card_and_plain(label, fn, args_cpu, kernel):
        """fn on the card through the kernel and through its plain version, and on the CPU:
        kernel vs plain and card vs CPU at the operators' bar."""
        args = [a.to(dev) if hasattr(a, "to") else tuple(t.to(dev) for t in a) for a in args_cpu]
        before = _launch_counts()
        got = fn(*args)
        launched = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
        with _plain_kernels():
            plain = fn(*args)
        if set(launched) != {kernel}:
            fail(f"{label}: launched {launched}, not {kernel} alone")
        check(f"{label}, kernel vs plain", maxdiff(got, plain), bar, kernel)
        check(f"{label}, card vs CPU", maxdiff(got.cpu(), fn(*args_cpu)), bar)

    for lat in ((4, 4, 4, 4), (4, 2, 4, 2), (4, 4, 4, 8)):
        name = "x".join(map(str, lat))
        u = apply_boundary_phases(fields.hot_start(lat, 3, seed=90, dtype=c128, device="cpu"))
        gen = torch.Generator().manual_seed(91)
        psi = gaussian_spinor(lat, 3, dtype=c128, device="cpu", generator=gen)
        check(f"clover term {name}, card vs CPU",
              maxdiff(d.clover_term(u.to(dev)).cpu(), d.clover_term(u)), bar)
        card_and_plain(f"clover D {name}", d.apply, (u, psi), "wilson_window")
        card_and_plain(f"clover D^dag {name}", d.apply_dagger, (u, psi), "wilson_window")
        (a_e, ainv_o), (g_e, ginv_o) = d.clover_packed_blocks(u), d.clover_packed_blocks(u.to(dev))
        check(f"clover blocks A_ee, A_oo^-1 {name}, card vs CPU",
              max(maxdiff(g_e.cpu(), a_e), maxdiff(ginv_o.cpu(), ainv_o)), bar)
        x_e = eo_pack.pack(psi, lat, 0)
        ueo = d.packed_links(u)
        card_and_plain(f"clover Dhat {name}",
                       lambda ue, ae, ai, x: d.apply_dhat_clover(ue, ae, ai, x),
                       (ueo, a_e, ainv_o, x_e), "wilson_hop_packed")
        card_and_plain(f"clover Dhat^dag {name}",
                       lambda ue, ae, ai, x: d.apply_dhat_clover_dagger(ue, ae, ai, x),
                       (ueo, a_e, ainv_o, x_e), "wilson_hop_packed")

    lat = (4, 4, 4, 4)
    u = fields.hot_start(lat, 3, seed=92, dtype=c128, device="cpu")
    ug = u.to(dev)
    fa = WilsonFermiAction(d, eps_cg=1e-24)
    _, phi = fa.sample_pseudofermion(u, generator=torch.Generator().manual_seed(93))
    before = _launch_counts()
    f_k = fa.force(ug, phi.to(dev))
    launched = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
    with _plain_kernels():
        f_p = fa.force(ug, phi.to(dev))
    f_c = fa.force(u, phi)
    if set(launched) != {"wilson_window"}:
        fail(f"the clover force launched {launched}, not wilson_window alone")
    scale = float(f_c.abs().max())
    check("clover force, kernel vs plain (relative)", maxdiff(f_k, f_p) / scale, 1e-10)
    check("clover force, card vs CPU (relative)", maxdiff(f_k.cpu(), f_c) / scale, 1e-10)

    # trajectories, kernel path against plain path: clover HMC runs on the full volume
    # (wilson_window alone); Hasenbusch + SW on the packed Dhat at csw = 0 (wilson_hop_packed
    # alone) and on the full clover D at csw != 0 (wilson_window alone)
    gauge = ga.wilson_gauge_action(3, CLOVER_BETA)
    cases = [
        ("clover HMC (QPQ)", HMC(action=gauge, dtau=0.05, md_steps=5, fermi_action=fa),
         "wilson_window"),
        ("Hasenbusch + SW nsw 2, csw 0", HMC(
            action=gauge, dtau=0.1, md_steps=3, sexton_weingarten=True, nsw=2,
            fermi_action=HasenbuschWilsonFermiAction(WilsonDirac(kappa=CLOVER_KAPPA), mu=0.5,
                                                     eps_cg=1e-24)), "wilson_hop_packed"),
        (f"Hasenbusch + SW nsw 2, csw {CLOVER_CSW}", HMC(
            action=gauge, dtau=0.1, md_steps=3, sexton_weingarten=True, nsw=2,
            fermi_action=HasenbuschWilsonFermiAction(d, mu=0.5, eps_cg=1e-24)), "wilson_window"),
    ]
    for i, (label, hmc, kernel) in enumerate(cases):
        launched = _trajectory_pair(torch, label, hmc, ug, 94 + i)
        if set(launched) != {kernel}:
            fail(f"{label}: the trajectory launched {launched}, not {kernel} alone")

    # the clover measurements, kernel path against plain path (solves to 1e-24 relative)
    tight = 1e-24
    lat = (4, 4, 4, 8)
    u = fields.hot_start(lat, 3, seed=97, dtype=c128, device=dev)
    launched = _kernel_vs_plain("clover pion correlator 4x4x4x8 (Schur)",
                                lambda: fermionic.pion_correlator(u, d, eps=tight))
    if set(launched) != {"wilson_hop_packed"}:
        fail(f"the clover Schur solve launched {launched}, not wilson_hop_packed alone")
    draws = np.random.default_rng(98).integers(0, 4, (3,) + lat + (4, 3))
    _kernel_vs_plain("clover pbp per noise 4x4x4x8",
                     lambda: fermionic.chiral_condensate(u, d, nr=3, draws=draws, eps=tight)[1])
    v0 = gaussian_spinor(lat, 3, dtype=c128, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(99))
    launched = _kernel_vs_plain("clover low spectrum 4x4x4x8",
                                lambda: fermionic.dirac_low_spectrum(u, d, k=4, m=32, v0=v0))
    if set(launched) != {"wilson_window"}:
        fail(f"the clover spectrum launched {launched}, not wilson_window alone")


def phase_clover_path(torch):
    print(f"== 27. clover path: run_lqcd_params, 16^3x32 beta {CLOVER_BETA} two-flavour clover "
          f"Wilson (kappa {CLOVER_KAPPA}, csw {CLOVER_CSW}), complex64, 2 trajectories with the "
          "clover measurements at itrj 0 and 2, then 2 Hasenbusch (mu 0.5) trajectories with "
          "Sexton-Weingarten nsw 2", flush=True)
    import numpy as np

    from latticeqcd_torch.measurements import scheduler
    from latticeqcd_torch.ops import sun
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from latticeqcd_torch.ops.fermion_action import HasenbuschWilsonFermiAction
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params
    from latticeqcd_torch.updates.hmc import HMC

    maxcg = 3000
    clover = {"Dirac_operator": "WilsonClover", "hop": CLOVER_KAPPA,
              "Clover_coefficient": CLOVER_CSW}
    methods = [
        {"methodname": "Pion_correlator", "fermion_parameters": clover, "MaxCGstep": maxcg},
        {"methodname": "Chiral_condensate", "fermion_parameters": clover, "Nr": 10,
         "MaxCGstep": maxcg},
        {"methodname": "Dirac_spectrum", "fermion_parameters": clover, "Neig": 8, "Nlanczos": 48},
    ]
    base = dict(L=MAIN, NC=3, beta=CLOVER_BETA, initial="hot", update_method="HMC", quench=False,
                Dirac_operator="WilsonClover", hop=CLOVER_KAPPA, Clover_coefficient=CLOVER_CSW,
                r=1.0, BoundaryCondition=(1, 1, 1, -1), QPQ=True, dtau=0.02, MDsteps=10,
                Nsteps=2, eps=1e-12, MaxCGstep=maxcg, randomseed=3, verboselevel=1)
    runs = [("clover HMC", Params(**base, measurement_methods=[
                {**m, "measure_every": 2} for m in methods])),
            ("clover Hasenbusch + SW", Params(**base, hasenbusch=True, hasenbusch_mu=0.5,
                                              SextonWeingargten=True, N_SextonWeingargten=2,
                                              measurement_methods=[]))]
    step, sample = HMC.step, HasenbuschWilsonFermiAction.sample_pseudofermion
    traj, samples, records, last = [], [], [], {}

    def stepped(self, u, generator=None, draws=None):
        torch.cuda.synchronize()
        before = _launch_counts()
        out = step(self, u, generator, draws)
        torch.cuda.synchronize()
        traj.append({k: v - before[k] for k, v in _launch_counts().items()})
        last.update(u=out[0], fa=self.fermi_action)
        return out

    def sampled(self, u, generator=None, normals=None, log=None):
        log = [] if log is None else log
        out = sample(self, u, generator, normals, log=log)
        samples.extend(log)  # the heavy solve of phi2, which HMC.step does not log
        return out

    def timed(cls):
        measure = cls.measure

        def wrapper(self, u, itrj, additional_string=""):
            torch.cuda.synchronize()
            before = _launch_counts()
            t0 = time.time()
            line = measure(self, u, itrj, additional_string)
            torch.cuda.synchronize()
            records.append({"method": self.name, "itrj": itrj, "seconds": time.time() - t0,
                            "value": self.value, "solves": self.solves,
                            "launches": {k: v - before[k] for k, v in _launch_counts().items()}})
            return line

        return mock.patch.object(cls, "measure", wrapper)

    for label, p in runs:
        history = []
        traj.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ww.launches = wk.launches = sk.launches = sk.w_launches = sk.fused_launches = 0
        wk.site_launches.update(full=0, packed=0)
        with mock.patch.object(HMC, "step", stepped), \
                mock.patch.object(HasenbuschWilsonFermiAction, "sample_pseudofermion", sampled), \
                timed(scheduler.PionCorrelatorMeasurement), \
                timed(scheduler.ChiralCondensateMeasurement), \
                timed(scheduler.DiracSpectrumMeasurement):
            t0 = time.time()
            plaq = run_lqcd_params(p, make_dirs=False, dtype=torch.complex64, device="cuda",
                                   history=history)
        torch.cuda.synchronize()
        total = time.time() - t0
        counts, site = _launch_counts(), dict(wk.site_launches)
        peak = torch.cuda.max_memory_allocated()
        for name in ("wilson_window", "wilson_hop_packed"):
            if counts[name]:
                STATE["launches"].setdefault(name, {})[label] = counts[name]
        for rec, launched in zip(history, traj):
            iters = [c["iterations"] for c in rec["cg"]]
            worst = max((c["rsq"] / c["target"] for c in rec["cg"]), default=0.0)
            print(f"  {label} trajectory {rec['itrj']}: {rec['seconds']:.3f} s  {len(iters)} "
                  f"solves, CG iterations per solve {statistics.mean(iters):.1f} (most "
                  f"{max(iters)})  dH {rec['dH']:.6f}  accepted {rec['accepted']}  plaquette "
                  f"{rec['plaq']:.8f}  worst verified residual/target {worst:.3g}  launches "
                  f"{launched}  [{STATE['smi']}]", flush=True)
            STATE["checks"] += 1
            if not math.isfinite(rec["dH"]):
                fail(f"non-finite dH {rec['dH']}")
            if worst > 1.0 or max(iters) >= maxcg:
                fail("a CG reached MaxCGstep or returned a verified residual above its target")
            if not 0.0 < rec["plaq"] < 1.0:
                fail(f"plaquette {rec['plaq']} outside (0, 1)")
            if launched["wilson_window"] == 0 or launched["wilson_hop_packed"]:
                fail(f"a {label} trajectory launched {launched}: the clover MD runs on "
                     "wilson_window alone")
        defect = float(sun.unitarity_defect(last["u"]))
        print(f"  {label}: run_lqcd_params {total:.3f} s, final plaquette {plaq:.8f}, unitarity "
              f"defect {defect:.3e}; launches on the path {counts}, wilson_hop {site}; "
              f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB  [{STATE['smi']}]",
              flush=True)
        STATE["checks"] += 1
        if defect > 1e-4:
            fail(f"unitarity defect {defect} after the run exceeds 1e-4")
        if not (math.isfinite(plaq) and 0.0 < plaq < 1.0):
            fail(f"plaquette {plaq} outside (0, 1)")
        if site["packed"] or sk.fused_launches:
            fail(f"{label}: a kernel off the paths was launched")
    print(f"  Hasenbusch pseudofermion (heavy) solves: iterations "
          f"{[c['iterations'] for c in samples]}", flush=True)
    if len(samples) != 2 or any(c["iterations"] >= maxcg or c["rsq"] > c["target"]
                                for c in samples):
        fail("a Hasenbusch pseudofermion solve is missing, reached MaxCGstep or missed its target")
    for rec in records:
        value, solves = rec["value"], rec["solves"] or []
        if rec["method"] == "Dirac_spectrum":
            shown = " ".join(f"{v:.6g}" for v in value)
            work = f"{len(value)} Ritz values from 48 Lanczos steps"
        else:
            work = (f"CG iterations {sum(c['iterations'] for c in solves)} in {len(solves)} "
                    f"solve(s) of {sum(c.get('rhs', 1) for c in solves)} RHS")
            if rec["method"] == "Chiral_condensate":
                shown = f"pbp {value[0]:.8g}"
                value = [value[0]] + list(value[1])
            else:
                shown = "C(t) " + " ".join(f"{v:.4g}" for v in value[:4]) + " ..."
        print(f"  itrj {rec['itrj']} {rec['method']} (clover): {rec['seconds']:.3f} s  {work}  "
              f"launches {rec['launches']}  {shown}  [{STATE['smi']}]", flush=True)
        STATE["checks"] += 1
        if not np.all(np.isfinite(np.asarray(value, dtype=np.float64))):
            fail(f"{rec['method']} gave a value that is not finite")
        if any(c["iterations"] >= maxcg or c["rsq"] > c["target"] for c in solves):
            fail(f"a {rec['method']} solve reached MaxCGstep or missed its target")
        if rec["method"] == "Pion_correlator" and not np.all(np.asarray(value) > 0):
            fail("the clover pion correlator is not positive")
        if rec["method"] == "Dirac_spectrum" and not (
                np.all(np.diff(value) >= 0) and np.all(np.asarray(value) > 0)):
            fail("the clover low eigenvalues are not ascending and positive")
        kernel = "wilson_window" if rec["method"] == "Dirac_spectrum" else "wilson_hop_packed"
        if rec["launches"][kernel] == 0:
            fail(f"the clover {rec['method']} launched {kernel} no time")
    if sorted((r["method"], r["itrj"]) for r in records) != sorted(
            (m["methodname"], i) for m in methods for i in (0, 2)):
        fail("the clover path did not run every method at itrj 0 and 2")

    # on the Hasenbusch run's last links: the clover term and its site product against their
    # bounds, the smallest eigenvalue of A_oo, one heavy and one light force
    u, fa = last["u"], last["fa"]
    d = fa.dirac
    up = apply_boundary_phases(u, d.bc)
    vol = math.prod(MAIN)
    gen = torch.Generator(device=u.device).manual_seed(6)
    cot = torch.randn(vol * 144, dtype=u.dtype, device=u.device, generator=gen).view(
        MAIN + (4, 3, 4, 3))

    def build_vjp():
        uu = up.detach().requires_grad_(True)
        with torch.enable_grad():
            torch.autograd.grad(d.clover_term(uu), uu, grad_outputs=cot)

    t = d.clover_term(up)
    a_e, ainv_o = d.clover_packed_blocks(up)
    psi = torch.randn(MAIN + (4, 3), dtype=u.dtype, device=u.device, generator=gen)
    x_o = eo_pack.pack(psi, MAIN, 1)
    build = _time_eager(torch, lambda: d.clover_term(up), n=10, warm=2)
    build_bwd = _time_eager(torch, build_vjp, n=5, warm=1)
    site = _time_device(torch, lambda: d.site_apply(t, psi), reps=8, n=10)
    site_packed = _time_device(torch, lambda: d.site_apply(ainv_o, x_o), reps=8, n=10)
    link_bytes, block_bytes = vol * 4 * 9 * 8, vol * 144 * 8
    bound = lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3  # noqa: E731
    a_o = eo_pack.pack(d.clover_site_matrix(up), MAIN, 1)
    # on the host: cuSOLVER's batched eigvalsh refuses a batch of 65536 matrices
    # (CUSOLVER_STATUS_INVALID_VALUE with torch 2.11, CUDA 12.8, on an H100)
    lam = torch.linalg.eigvalsh(a_o.reshape(-1, 12, 12).cpu().to(torch.complex128))
    print(f"  16^3x32 complex64 on the run's links: clover term build {build:.3f} ms eager "
          f"(bound {bound(link_bytes + block_bytes):.4f} ms: links in, "
          f"{block_bytes / 1e6:.1f} MB of site matrices out), build forward + backward "
          f"{build_bwd:.3f} ms (bound {bound(2 * link_bytes + 2 * block_bytes):.4f} ms); "
          f"12x12 site product {site:.4f} ms device, full volume (bound "
          f"{bound(vol * (1152 + 192)):.4f} ms), packed A_oo^-1 {site_packed:.4f} ms (bound "
          f"{bound(vol // 2 * (1152 + 192)):.4f} ms); A_oo eigenvalues in "
          f"[{float(lam.min()):.4f}, {float(lam.max()):.4f}]  [{STATE['smi']}]", flush=True)
    STATE["checks"] += 1
    if not float(lam.min()) > 0.0:
        fail(f"A_oo is not positive definite: smallest eigenvalue {float(lam.min())}")
    _, phi = fa.sample_pseudofermion(u, generator=gen)
    for name in ("force_heavy_with_guess", "force_light_with_guess"):
        log = []
        ms = _time_eager(torch, lambda: getattr(fa, name)(u, phi, None, log=log), n=3, warm=1)
        print(f"  one {name[:-len('_with_guess')].replace('_', ' ')} (its solve from zero, "
              f"{log[-1]['iterations']} CG iterations, and the backward through wilson_window "
              f"and the clover term): {ms:.1f} ms eager  [{STATE['smi']}]", flush=True)


# ------------------------------------------------------------------ mixed MD and batched chains

CHAIN_COUNTS = (1, 3, 8)
# the chain-axis launches of phase 29's batched paths, checked at their own shapes in phase 28:
# the tier2 Wilson chains, staggered Nf = 4, clover Hasenbusch + SW (the full D) and domain
# wall (the Schur operator's packed hops)
PATH_CHAINS = [((4, 4, 4, 4), "wilson", 64), ((8, 8, 8, 8), "staggered", 16),
               ((8, 8, 8, 8), "window", 16), ((4, 4, 4, 4), "wilson", 16)]
# wilson_window's chain axis: phase 3's lattices with an odd one, and the timed shapes
WINDOW_CHAIN_LATTICES = [(4, 4, 4, 4), (3, 5, 2, 6), (8, 6, 10, 4), MAIN]
WINDOW_CHAINS_TIMED = ((8, 8, 8, 8), 16)


def _zero_counts():
    """Set every kernel's launch count to 0."""
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    wk.launches = ww.launches = wk.halo_launches = ww.chain_launches = 0
    wk.site_launches.update(full=0, packed=0)
    sk.launches = sk.w_launches = sk.fused_launches = 0


def _off_path_launches():
    """The launches of the kernels no path may run: wilson_hop's packed mode and the
    one-launch staggered W."""
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk

    return wk.site_launches["packed"] + sk.fused_launches


def _chain_links(torch, u, dtype, n):
    """(u_e, u_o) of n chains with the boundary phases, chain axis in front: chain c holds the
    links u shifted by c sites along t and times the phase exp(0.1 i c) (the hops are linear
    in the links), so that no two chains' links are equal."""
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    pairs = [eo_pack.pack_links(apply_boundary_phases(
        (torch.roll(u, c, 4) * complex(math.cos(0.1 * c), math.sin(0.1 * c))).to(dtype)),
        tuple(u.shape[1:5])) for c in range(n)]
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _window_chain_links(torch, u, dtype, n):
    """n chains of full links with the boundary phases, chain c as in _chain_links."""
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases

    return torch.stack([apply_boundary_phases(
        (torch.roll(u, c, 4) * complex(math.cos(0.1 * c), math.sin(0.1 * c))).to(dtype))
        for c in range(n)])


def _window_chain_checks(torch, u, r, tag, bar):
    """wilson_window with a chain axis at Wilson r: forward (one launch for all chains,
    counted in chain_launches and at r != 1 in r_launches) and the backward for the links
    and the field, against the plain per-chain D and its autograd."""
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    n = u.shape[0]
    g = torch.Generator(device=u.device).manual_seed(n + 7)
    shape = (n,) + tuple(u.shape[2:6]) + (4, 3)
    x, cot = (torch.randn(shape, dtype=u.dtype, device=u.device, generator=g) for _ in range(2))
    counts = lambda: (ww.launches, ww.chain_launches, ww.r_launches)  # noqa: E731
    before = counts()
    got = ww.wilson_window(u, x, KAPPA, r)
    torch.cuda.synchronize()
    if counts() != (before[0] + 1, before[1] + 1, before[2] + (r != 1.0)):
        fail(f"wilson_window with {n} chains at r = {r}: launches {counts()} from {before}, "
             "not one chain launch")
    want = torch.stack([wk.dslash_reference(u[c], x[c], KAPPA, r) for c in range(n)])
    check(f"window D n={n} r={r} {tag}", maxdiff(got, want), bar, "wilson_window_chains")
    leaves = [t.detach().clone().requires_grad_(True) for t in (u, x)]
    grads = torch.autograd.grad(ww.wilson_window(*leaves, KAPPA, r), leaves, cot)
    err = 0.0
    for c in range(n):
        one = [t[c].detach().clone().requires_grad_(True) for t in (u, x)]
        plain = torch.autograd.grad(wk.dslash_reference(*one, KAPPA, r), one, cot[c])
        for a, b in zip(grads, plain):
            err = max(err, maxdiff(a[c], b))
    torch.cuda.synchronize()
    check(f"window D n={n} r={r} backward (u, psi) {tag}", err, bar, "wilson_window_chains")


def _window_chain_timing(torch):
    """wilson_window's chain axis timed (CUDA graphs between CUDA events, cold: three input
    sets in turn): at 16^3x32 a chain axis of one (the chains entry point) beside the lattice
    without a chain axis (the one-chain entry point), in turns (without, with, with, without);
    16 chains at 8^4 in one launch beside the same 16 lattices as 16 one-chain launches, each
    beside the bound (480 B a site at complex64, 960 at complex128)."""
    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    vol = MAIN[0] * MAIN[1] * MAIN[2] * MAIN[3]
    lat, n = WINDOW_CHAINS_TIMED
    cvol = n * lat[0] * lat[1] * lat[2] * lat[3]
    with torch.no_grad():
        for dtype in (torch.complex64, torch.complex128):
            name = str(dtype).split(".")[1]
            f = 2 if dtype == torch.complex128 else 1
            sets = [_fields(torch, MAIN, dtype, seed=seed)[:2] for seed in (7, 8, 9)]
            single = [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in sets]
            one = [(s[0][None], s[1][None]) for s in sets]
            chain = [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in one]
            turns = {"without": [], "with": []}
            for label in ("without", "with", "with", "without"):
                turns[label].append(_time_device(torch, single if label == "without" else chain))
            bound = f * 480 * vol / HBM_BYTES_PER_S * 1e3
            print(f"  window D {name} 16^3x32 one lattice, cold, in turns (without, with, with, "
                  f"without a chain axis): without "
                  f"{' '.join(f'{t * 1e3:.1f}' for t in turns['without'])} us, a chain axis of "
                  f"one {' '.join(f'{t * 1e3:.1f}' for t in turns['with'])} us, bound "
                  f"{bound * 1e3:.1f} us  [{STATE['smi']}]", flush=True)
            del sets, one
            csets = []
            for seed in (10, 11, 12):
                u = fields.hot_start(lat, 3, seed=seed, device="cuda")
                g = torch.Generator(device=u.device).manual_seed(seed)
                csets.append((_window_chain_links(torch, u, dtype, n),
                              torch.randn((n,) + lat + (4, 3), dtype=dtype, device=u.device,
                                          generator=g)))
            us, xs = csets[0]
            label = f"window D {n} chains {lat[0]}^4"
            _time_case(torch, label, name,
                       [lambda s=s: ww.wilson_window(s[0], s[1], KAPPA) for s in csets],
                       lambda: wk.dslash_reference(us, xs, KAPPA), f * 480 * cvol, 1320 * cvol)
            apart = _time_device(torch, [lambda s=s: [ww.wilson_window(s[0][c], s[1][c], KAPPA)
                                                      for c in range(n)] for s in csets])
            t_one = STATE["timing"][(label, name)]["ms"]
            bound = STATE["timing"][(label, name)]["bound_ms"]
            print(f"  {label} {name}: one launch {t_one * 1e3:.1f} us ({100 * bound / t_one:.1f}% "
                  f"of the {bound * 1e3:.1f} us bound), {n} one-chain launches {apart * 1e3:.1f} us "
                  f"({100 * bound / apart:.1f}%), cold  [{STATE['smi']}]", flush=True)


def _chain_hop_checks(torch, mod, name, hop, plain, site, u_e, u_o, tag, bar):
    """The chain-axis hop of both target parities, forward (one launch for all chains)
    and backward, against the plain per-chain hop and its autograd."""
    n = u_e.shape[0]
    g = torch.Generator(device=u_e.device).manual_seed(n)
    shape = (n,) + tuple(u_e.shape[2:6]) + site
    x = torch.randn(shape, dtype=u_e.dtype, device=u_e.device, generator=g)
    cot = torch.randn(shape, dtype=u_e.dtype, device=u_e.device, generator=g)
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        before = mod.launches
        got = hop(u_t, u_s, x, parity)
        torch.cuda.synchronize()
        if mod.launches != before + 1:
            fail(f"{name} with {n} chains launched {mod.launches - before} times, not once")
        want = torch.stack([plain(u_t[c], u_s[c], x[c], parity) for c in range(n)])
        check(f"{name} n={n} hop p={parity} {tag}", maxdiff(got, want), bar, name)
        leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
        grads = torch.autograd.grad(hop(*leaves, parity), leaves, cot)
        err = 0.0
        for c in range(n):
            one = [t[c].detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
            for a, b in zip(grads, torch.autograd.grad(plain(*one, parity), one, cot[c])):
                err = max(err, maxdiff(a[c], b))
        torch.cuda.synchronize()
        check(f"{name} n={n} backward (u_t, u_s, psi) p={parity} {tag}", err, bar, name)


def _batched_against_single(torch, label, hmc, us, seed, expect=()):
    """step_batched of the chains us against one step per chain from the same draws
    (even chains accepted whatever dH, so their evolved links are compared); the kernels
    named in ``expect`` must have launched in the batched step ("wilson_window chain": the
    full D with a chain axis)."""
    from latticeqcd_torch.updates.hmc import Draws

    n = us.shape[0]
    draws = []
    for i in range(n):
        d = Draws.sample(hmc, us[i], torch.Generator(device=us.device).manual_seed(seed + i))
        draws.append(Draws(d.mom, d.xi, 0.0 if i % 2 == 0 else d.uniform))
    before = _batched_counts()
    u_b, st_b = hmc.step_batched(us, draws=draws)
    mid = _batched_counts()
    worst_dh = worst_u = 0.0
    for i in range(n):
        u_i, st_i = hmc.step(us[i], draws=draws[i])
        worst_dh = max(worst_dh, abs(float(st_b["dH"][i]) - st_i["dH"]))
        worst_u = max(worst_u, maxdiff(u_b[i], u_i))
        if bool(st_b["accepted"][i]) != st_i["accepted"]:
            fail(f"{label}: chain {i} batched and alone disagree on accept")
    after = _batched_counts()
    batched = {k: mid[k] - before[k] for k in mid if mid[k] != before[k]}
    single = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
    print(f"  {label}: {n} chains, dH {[round(float(d), 6) for d in st_b['dH']]}; launches "
          f"batched {batched}, {n} single steps {single}; CG iterations batched "
          f"{sum(c['iterations'] for c in st_b['cg'])} in {len(st_b['cg'])} solves", flush=True)
    if not hmc.quench and not batched:
        fail(f"{label}: step_batched launched no kernel")
    for name in expect:
        if not batched.get(name):
            fail(f"{label}: step_batched launched no {name}")
    check(f"{label} batched against single |ddH|", worst_dh, 1e-10)
    check(f"{label} batched against single max|dU|", worst_u, 1e-12)


def phase_batched_agreement(torch):
    print("== 28. chain-axis kernels and batched chains against their plain and single-chain "
          "versions; mixed MD", flush=True)
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC, Draws

    t0 = time.time()
    dev = torch.device("cuda")
    dtypes = (torch.complex64, torch.complex128)
    cases = ([(lat, "wilson", d, n) for lat in LATTICES for d in dtypes for n in CHAIN_COUNTS]
             + [(lat, "staggered", d, n) for lat in STAGGERED_LATTICES for d in dtypes
                for n in CHAIN_COUNTS]
             + [(lat, kind, torch.complex64, n) for lat, kind, n in PATH_CHAINS])
    links = {}
    cases += [(lat, "window", d, n) for lat in WINDOW_CHAIN_LATTICES for d in dtypes
              for n in CHAIN_COUNTS]
    for lat, kind, dtype, n in cases:
        if (lat, kind) not in links:
            links[lat, kind] = fields.hot_start(lat, 3, seed=sum(lat) + (kind == "staggered"),
                                                device=dev)
        u = links[lat, kind]
        name = str(dtype).split(".")[1]
        tag = f"{'x'.join(map(str, lat))} {name}"
        if kind == "window":  # the full D, at r = 1 and in the r mode
            uc = _window_chain_links(torch, u, dtype, n)
            for r in (1.0, R_MODE):
                _window_chain_checks(torch, uc, r, tag, BARS[name])
            continue
        u_e, u_o = _chain_links(torch, u, dtype, n)
        if kind == "wilson":
            _chain_hop_checks(torch, wk, "wilson_hop_packed", wk.wilson_hop_packed,
                              wk.hop_packed_reference, (4, 3), u_e, u_o, tag, BARS[name])
        else:
            _chain_hop_checks(torch, sk, "staggered_w", sk.staggered_hop_packed,
                              sk.staggered_hop_packed_reference, (3,), u_e, u_o, tag,
                              BARS[name])
            x = torch.randn((n,) + tuple(u_e.shape[2:6]) + (3,), dtype=dtype,
                            device=u_e.device, generator=torch.Generator(
                                device=u_e.device).manual_seed(n + 1))
            before = sk.w_launches
            got = sk.staggered_w(u_e, u_o, x, MASS)
            torch.cuda.synchronize()
            if sk.w_launches != before + 1:
                fail(f"staggered_w's W with {n} chains did not launch once")
            want = torch.stack([sk.staggered_w_reference(u_e[c], u_o[c], x[c], MASS)
                                for c in range(n)])
            check(f"staggered_w n={n} W {tag}", maxdiff(got, want), BARS[name], "staggered_w")
    print(f"  chain-axis kernels checked in {time.time() - t0:.1f} s", flush=True)
    _window_chain_timing(torch)

    lat = (4, 4, 4, 4)
    us = torch.stack([fields.hot_start(lat, 3, seed=280 + i, device=dev) for i in range(4)])
    cases = {
        "quenched": (6.0, None),
        "Wilson": (6.0, WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19)),
        "staggered Nf=4": (5.7, StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat),
                                                     nf=4, eps_cg=1e-19)),
        "staggered Nf=2": (5.7, StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat),
                                                     nf=2, eps_cg=1e-19)),
    }
    for i, (label, (beta, fa)) in enumerate(cases.items()):
        hmc = HMC(action=ga.wilson_gauge_action(3, beta), dtau=0.1, md_steps=5, fermi_action=fa)
        _batched_against_single(torch, f"4^4 c128 {label}", hmc, us, 290 + 10 * i)

    # mixed MD: complex128 against plain complex128, and a complex64 Wilson trajectory through
    # the kernels against the plain path
    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-19)
    kw = dict(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10, fermi_action=fa)
    u = us[0]
    d = Draws.sample(HMC(**kw), u, torch.Generator(device=dev).manual_seed(300))
    draws = Draws(d.mom, d.xi, 0.0)
    u_p, st_p = HMC(**kw).step(u, draws=draws)
    u_m, st_m = HMC(**kw, md_precision="mixed").step(u, draws=draws)
    print(f"  mixed c128 dH {st_m['dH']:.12f}, plain c128 dH {st_p['dH']:.12f}", flush=True)
    check("mixed c128 against plain c128 |ddH|", abs(st_m["dH"] - st_p["dH"]), 1e-9)
    check("mixed c128 against plain c128 max|dU|", maxdiff(u_m, u_p), 1e-12)
    fa64 = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-12)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.02, md_steps=10, fermi_action=fa64,
              md_precision="mixed")
    u64 = u.to(torch.complex64)
    draws = Draws.sample(hmc, u64, torch.Generator(device=dev).manual_seed(301))
    before = _launch_counts()
    u_k, st_k = hmc.step(u64, draws=draws)
    launched = {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}
    with _plain_kernels():
        u_q, st_q = hmc.step(u64, draws=draws)
    print(f"  mixed c64 Wilson: kernel dH {st_k['dH']:.8f} accepted {st_k['accepted']} "
          f"({launched} launches); plain dH {st_q['dH']:.8f} accepted {st_q['accepted']}",
          flush=True)
    if not launched.get("wilson_hop_packed"):
        fail("the mixed complex64 trajectory launched no wilson_hop_packed")
    if u_k.dtype != torch.complex64:
        fail(f"the mixed trajectory handed on {u_k.dtype} links")
    check("mixed c64 Wilson kernel against plain |ddH|", abs(st_k["dH"] - st_q["dH"]), 5e-4)
    if st_k["accepted"] != st_q["accepted"]:
        fail("mixed c64 kernel and plain trajectories disagree on accept")


def _wilson_path_params(**kw):
    """Phase 6's Wilson action at 16^3x32 (hot start, seed 3)."""
    from latticeqcd_torch.system.params import Params

    base = dict(
        L=MAIN, NC=3, beta=6.0, initial="hot", update_method="HMC", quench=False,
        Dirac_operator="Wilson", hop=KAPPA, r=1.0, BoundaryCondition=(1, 1, 1, -1),
        QPQ=True, dtau=0.02, MDsteps=10, Nsteps=2, eps=1e-12, MaxCGstep=3000,
        randomseed=3, verboselevel=2,
        measurement_methods=[{"methodname": "Plaquette", "measure_every": 1}],
    )
    base.update(kw)
    return Params(**base)


def _batched_counts():
    """_launch_counts with wilson_window's launches with a chain axis."""
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    return {**_launch_counts(), "wilson_window chain": ww.chain_launches}


def _batched_run(torch, label, hmc, us, nsteps, seed):
    """nsteps step_batched of the chains us, then 4 single-chain steps of chain 0 in the same
    process; prints and returns the seconds and launches."""
    n = us.shape[0]
    gens = [torch.Generator(device=us.device).manual_seed(seed + i) for i in range(n)]
    torch.cuda.synchronize()
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    launches = {}
    secs = []
    for k in range(nsteps):
        before = _batched_counts()
        t0 = time.time()
        us, st = hmc.step_batched(us, generators=gens)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        diff = {kk: v - before[kk] for kk, v in _batched_counts().items() if v != before[kk]}
        for kk, v in diff.items():
            launches[kk] = launches.get(kk, 0) + v
        iters = [c["iterations"] for c in st["cg"]]
        print(f"  {label} batched trajectory {k + 1}: {secs[-1]:.3f} s for {n} chains, "
              f"{n / secs[-1]:.2f} configurations/s; launches {diff}; CG iterations {sum(iters)} "
              f"in {len(iters)} batched solves (at most {max(iters, default=0)}); accepted "
              f"{int(st['accepted'].sum())}/{n}; dH in [{float(st['dH'].min()):.4f}, "
              f"{float(st['dH'].max()):.4f}]  [{STATE['smi']}]", flush=True)
        if not torch.isfinite(st["dH"]).all():
            fail(f"{label}: a non-finite dH")
        if any(i >= 3000 for i in iters):
            fail(f"{label}: a batched solve stopped at its iteration limit")
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    if _off_path_launches():
        fail(f"{label}: the batched run launched a kernel no path may run")
    u1, g1 = us[0].clone(), torch.Generator(device=us.device).manual_seed(seed + n)
    single, single_launches = [], []
    for k in range(4):
        before = _launch_counts()
        t0 = time.time()
        u1, st1 = hmc.step(u1, g1)
        torch.cuda.synchronize()
        single.append(time.time() - t0)
        single_launches.append(sum(_launch_counts().values()) - sum(before.values()))
    s_b, s_1 = statistics.median(secs), statistics.median(single)
    STATE.setdefault("batched_cps", {})[label] = n / s_b
    print(f"  {label}: batched {s_b:.3f} s per trajectory of {n} chains ({n / s_b:.2f} "
          f"configurations/s), single chain {s_1:.3f} s ({1 / s_1:.2f} configurations/s, "
          f"{' '.join(f'{s:.3f}' for s in single)} s): {n * s_1 / s_b:.1f}x the configurations "
          f"per second; peak memory {peak:.3f} GiB above what was held before the batched "
          f"trajectories; launches over {nsteps} batched trajectories "
          f"{launches}, per single-chain trajectory {single_launches}  [{STATE['smi']}]",
          flush=True)
    return launches


def phase_batched_path(torch):
    print("== 29. mixed MD and batched chains on the paths", flush=True)
    from latticeqcd_torch.md import integrators
    from latticeqcd_torch.ops import fields, gauge_action as ga, mdpair, sun
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import StaggeredFermiAction, WilsonFermiAction
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.updates.hmc import HMC, Draws

    # mixed MD on the Wilson path, beside the plain run in this process
    seconds = {}
    for precision in ("auto", "mixed"):
        history = []
        torch.cuda.synchronize()
        _zero_counts()
        plaq = run_lqcd_params(_wilson_path_params(MDprecision=precision), make_dirs=False,
                               dtype=torch.complex64, device="cuda", history=history)
        torch.cuda.synchronize()
        seconds[precision] = [rec["seconds"] for rec in history]
        for rec in history:
            print(f"  MDprecision {precision} trajectory {rec['itrj']}: {rec['seconds']:.3f} s  "
                  f"CG iterations {sum(c['iterations'] for c in rec['cg'])} in {len(rec['cg'])} "
                  f"solves  dH {rec['dH']:.6f}  accepted {rec['accepted']}  plaquette "
                  f"{rec['plaq']:.8f}  [{STATE['smi']}]", flush=True)
            if not math.isfinite(rec["dH"]):
                fail(f"non-finite dH {rec['dH']} with MDprecision {precision}")
        if not (history and math.isfinite(plaq) and 0.0 < plaq < 1.0):
            fail(f"the {precision} Wilson run: plaquette {plaq}")
        if precision == "mixed":
            STATE["launches"].setdefault("wilson_hop_packed", {})["mixed Wilson path"] = wk.launches
            print(f"  wilson_hop_packed launches on the mixed path: {wk.launches}", flush=True)
            if wk.launches == 0:
                fail("the mixed path launched wilson_hop_packed no time")
            if _off_path_launches():
                fail("the mixed path launched a kernel no path may run")
    print(f"  s per trajectory, 16^3x32 c64 Wilson: plain {seconds['auto']}, mixed "
          f"{seconds['mixed']}  [{STATE['smi']}]", flush=True)

    # the same trajectory plain and mixed in turns (plain, mixed, mixed, plain), one set of draws
    dev = torch.device("cuda")
    act = ga.wilson_gauge_action(3, 6.0)
    c64 = torch.complex64
    u = fields.hot_start(MAIN, 3, seed=290, device=dev)
    u64 = u.to(c64)
    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-12, max_cg=3000)
    hmcs = {p: HMC(action=act, dtau=0.02, md_steps=10, fermi_action=fa, md_precision=p)
            for p in ("plain", "mixed")}
    draws = Draws.sample(hmcs["plain"], u64, torch.Generator(device=dev).manual_seed(292))
    turns = {"plain": [], "mixed": []}
    for precision in ("plain", "mixed", "mixed", "plain"):
        torch.cuda.synchronize()
        t0 = time.time()
        _, st = hmcs[precision].step(u64, draws=draws)
        torch.cuda.synchronize()
        turns[precision].append(time.time() - t0)
        turns[precision + " dH"] = st["dH"]
    print(f"  one 16^3x32 c64 Wilson trajectory in turns (plain, mixed, mixed, plain): plain "
          f"{' '.join(f'{t:.3f}' for t in turns['plain'])} s (dH {turns['plain dH']:.6f}), mixed "
          f"{' '.join(f'{t:.3f}' for t in turns['mixed'])} s (dH {turns['mixed dH']:.6f})  "
          f"[{STATE['smi']}]", flush=True)
    h = sun.random_hermitian_momentum(u.shape[:-2], 3, dtype=torch.complex128, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(291))
    h64 = h.to(c64)
    u_md, h_md = mdpair.lift(u64), mdpair.lift(h64)
    times = {"c64 link update": lambda: integrators.update_links(u64, h64, 0.01),
             "c128 link update (mixed)": lambda: integrators.update_links(u_md, h_md, 0.01),
             "c128 exponential": lambda: sun.expi_hermitian(h_md, 0.01),
             "lowering to c64": lambda: u_md.to(c64),
             "c64 gauge force": lambda: ga.force(act, u64)}
    print("  16^3x32 eager ms: " + ", ".join(f"{k} {_time_eager(torch, f, n=10, warm=2):.3f}"
                                             for k, f in times.items())
          + f"  [{STATE['smi']}]", flush=True)

    # the tracking property at 16^3x32: 5 quenched MD steps from one start
    def md(u0, h0, view):
        return integrators.run_md(u0, h0, lambda uu: ga.force(act, view(uu)), 0.02, 5)[0]

    u_ref = md(u, h, lambda uu: uu)
    u_pl = md(u.to(c64), h.to(c64), lambda uu: uu)
    u_mx = md(mdpair.lift(u.to(c64)), mdpair.lift(h.to(c64)), lambda uu: uu.to(c64))
    dev_plain = maxdiff(u_pl.to(torch.complex128), u_ref)
    dev_mixed = maxdiff(u_mx.to(c64).to(torch.complex128), u_ref)
    print(f"  tracking at 16^3x32, 5 steps of 0.02: plain c64 {dev_plain:.3e}, mixed c64 "
          f"{dev_mixed:.3e} from the complex128 trajectory ({dev_plain / dev_mixed:.1f}x)",
          flush=True)
    if not dev_mixed < dev_plain / 5.0:
        fail(f"mixed MD does not track the complex128 trajectory 5x closer: {dev_mixed} against "
             f"{dev_plain}")

    # batched chains: the reference's published workload (bench.py tier2) as 64 chains, and
    # staggered Nf = 4 at 8^4 as 16 chains
    lat = (4, 4, 4, 4)
    fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-12, max_cg=3000)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10, fermi_action=fa)
    us = torch.stack([fields.hot_start(lat, 3, seed=400 + i, dtype=c64, device=dev)
                      for i in range(64)])
    launched = _batched_run(torch, "tier2 4^4 Wilson c64", hmc, us, 2, seed=500)
    STATE["launches"].setdefault("wilson_hop_packed", {})["batched tier2 path"] = launched.get(
        "wilson_hop_packed", 0)
    if not launched.get("wilson_hop_packed"):
        fail("the batched Wilson chains launched wilson_hop_packed no time")

    lat = (8, 8, 8, 8)
    fa = StaggeredFermiAction(StaggeredDirac(mass=MASS, lattice=lat), nf=4, eps_cg=1e-12)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.02, md_steps=10, fermi_action=fa)
    us = torch.stack([fields.hot_start(lat, 3, seed=600 + i, dtype=c64, device=dev)
                      for i in range(16)])
    launched = _batched_run(torch, "8^4 staggered Nf=4 c64", hmc, us, 2, seed=700)
    STATE["launches"].setdefault("staggered_w", {})["batched staggered path"] = launched.get(
        "staggered_w", 0)
    if not launched.get("staggered_w"):
        fail("the batched staggered chains launched staggered_w no time")
    _batched_family(torch)


# The solves of phase 29(a): two roundings of a CG (the batched one's per-chain sums and a single
# chain's) stop within its target of each other, and at eps 1e-19 the clover action's solves
# alone moved dH by 3.2e-9 between the batched and the single-chain trajectory on the card
# (bitwise equal on the CPU, where both sum in one order); at 1e-24 the solves sit far below
# the 1e-10 bar on dH
EPS_FAMILY = 1e-24


def _batched_family(torch):
    """Phase 29 for the Wilson family: (a) step_batched of 2 chains against 2 single-chain steps
    at 4^4 complex128 for each action that has its batched form since wilson_window's chain axis;
    (b) phase 27's clover Hasenbusch + SW at 8^4 and phase 23's domain wall at 4^4, each as 16
    complex64 chains, timed against one chain."""
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import (DomainwallFermiAction,
                                                     HasenbuschWilsonFermiAction,
                                                     WilsonFermiAction)
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.updates.hmc import HMC

    dev = torch.device("cuda")
    chains = {lat: torch.stack([fields.hot_start(lat, 3, seed=800 + sum(lat) + i, device=dev)
                                for i in range(2)]) for lat in ((4, 4, 4, 4), (3, 4, 4, 4))}
    clover = WilsonDirac(kappa=CLOVER_KAPPA, csw=CLOVER_CSW)
    window, packed = ("wilson_window chain",), ("wilson_hop_packed",)
    eps = EPS_FAMILY
    four, three = (4, 4, 4, 4), (3, 4, 4, 4)
    runs = [  # label, fermion action, lattice, smearing, Sexton-Weingarten, kernels launched
        ("clover", WilsonFermiAction(clover, eps_cg=eps), four, None, False, window),
        ("Hasenbusch + SW", HasenbuschWilsonFermiAction(WilsonDirac(kappa=KAPPA), mu=0.5,
                                                        eps_cg=eps), four, None, True, packed),
        ("clover Hasenbusch + SW", HasenbuschWilsonFermiAction(clover, mu=0.5, eps_cg=eps), four,
         None, True, window),
        ("domain wall L5 4", DomainwallFermiAction(DomainwallDirac(0.3, DW_M5, 4), eps_cg=eps),
         four, None, False, packed),
        ("stout Wilson", WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=eps), four,
         stout_stack([0.1]), False, packed),
        (f"Wilson r = {R_MODE}", WilsonFermiAction(WilsonDirac(kappa=KAPPA, r=R_MODE), eps_cg=eps),
         four, None, False, packed),
        ("Wilson 3x4x4x4", WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=eps), three, None,
         False, window),
    ]
    for i, (label, fa, lat, smearing, sw, expect) in enumerate(runs):
        hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=3, fermi_action=fa,
                  smearing=smearing, sexton_weingarten=sw, nsw=2)
        _batched_against_single(torch, f"{'x'.join(map(str, lat))} c128 {label}", hmc,
                                chains[lat], 820 + 10 * i, expect)

    c64 = torch.complex64
    fa = HasenbuschWilsonFermiAction(clover, mu=0.5, eps_cg=1e-12, max_cg=3000)
    hmc = HMC(action=ga.wilson_gauge_action(3, CLOVER_BETA), dtau=0.02, md_steps=10,
              fermi_action=fa, sexton_weingarten=True, nsw=2)
    lat = (8, 8, 8, 8)
    us = torch.stack([fields.hot_start(lat, 3, seed=900 + i, dtype=c64, device=dev)
                      for i in range(16)])
    launched = _batched_run(torch, "8^4 clover Hasenbusch + SW c64", hmc, us, 2, seed=950)
    STATE["launches"].setdefault("wilson_window_chains", {})[
        "batched clover Hasenbusch + SW path"] = launched.get("wilson_window chain", 0)
    if not launched.get("wilson_window chain"):
        fail("the batched clover Hasenbusch chains launched wilson_window's chain form no time")

    fa = DomainwallFermiAction(DomainwallDirac(DW_MASS, DW_M5, DW_L5), eps_cg=1e-12, max_cg=3000)
    hmc = HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.02, md_steps=10, fermi_action=fa)
    lat = (4, 4, 4, 4)
    us = torch.stack([fields.hot_start(lat, 3, seed=960 + i, dtype=c64, device=dev)
                      for i in range(16)])
    launched = _batched_run(torch, f"4^4 domain wall L5 {DW_L5} c64", hmc, us, 2, seed=980)
    STATE["launches"].setdefault("wilson_hop_packed", {})["batched domain-wall path"] = (
        launched.get("wilson_hop_packed", 0))
    if not launched.get("wilson_hop_packed"):
        fail("the batched domain-wall chains launched wilson_hop_packed no time")


# phase 6's action as a legacy .jl input (the four-dict Julia format of
# latticeqcd_torch/system/legacy_input.py); {tmp} is the run's directory
WILSON_PATH_JL = """\
# phase 6's action: 16^3x32 SU(3), two-flavour Wilson HMC, QPQ 0.02 x 10
system["L"] = (16, 16, 16, 32)
system["β"] = 6.0
system["NC"] = 3
system["Nthermalization"] = 0
system["Nsteps"] = 2
system["initial"] = "hot"
system["initialtrj"] = 1
system["update_method"] = "HMC"
system["quench"] = false
system["Dirac_operator"] = "Wilson"
system["BoundaryCondition"] = [1, 1, 1, -1]
system["log_dir"] = "{tmp}/logs"
system["logfile"] = "wilson_path.txt"
system["saveU_format"] = nothing
system["verboselevel"] = 2
system["randomseed"] = 3
wilson["hop"] = 0.141139
wilson["r"] = 1
md["QPQ"] = true
md["MDsteps"] = 10
md["Δτ"] = 0.02
cg["eps"] = 1e-12
cg["MaxCGstep"] = 3000
measurement["measurement_basedir"] = "{tmp}/measurements"
measurement["measurement_dir"] = "wilson_path"
measurement["measurement_methods"] = Array{{Dict,1}}(undef, 1)
measurement["measurement_methods"][1]["methodname"] = "Plaquette"
measurement["measurement_methods"][1]["measure_every"] = 1
"""
# the Params fields a .jl file sets apart from the chain: where logs and measurements go
PATH_FIELDS = {"log_dir", "logfile", "measurement_basedir", "measurement_dir", "measuredir"}


def _subprocess(args, cwd, timeout):
    """Run python -m ... in cwd with the repository on the path; returns the finished process."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _frontend_jl(torch, tmp):
    """(a): phase 6's action from a .jl file through the façade, bit for bit phase 6's run."""
    import contextlib
    import dataclasses
    import io

    import latticeqcd_torch
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.system.params import construct_params_from_toml

    if "wilson_main" not in STATE:
        fail("phase 30 compares with phase 6's run: run phase_main_path first")
    main = STATE["wilson_main"]
    jl = os.path.join(tmp, "wilson_path.jl")
    with open(jl, "w") as f:
        f.write(WILSON_PATH_JL.format(tmp=tmp))
    out = io.StringIO()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        plaq = latticeqcd_torch.run_LQCD(jl, dtype=torch.complex64)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launched, site = wk.launches, dict(wk.site_launches)
    STATE["launches"].setdefault("wilson_hop_packed", {})["front end .jl"] = launched
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("input file", "Update:", "Snew", "# plaquette", "# CG", "Total",
                            "# phase timings", "#   update ", "#   measure ", "#   save ")):
            print(f"  | {line}")
    toml = os.path.join(tmp, "wilson_path.toml")
    if f"input file transformed to {toml}" not in text:
        fail("run_LQCD did not report the .jl file's transformation")
    got = dataclasses.asdict(construct_params_from_toml(toml, make_dirs=False))
    want = dataclasses.asdict(_wilson_path_params())
    differ = sorted(k for k in want if got[k] != want[k])
    print(f"  the .jl file's Params differ from phase 6's in {differ} only")
    if set(differ) - PATH_FIELDS:
        fail(f"the .jl file's Params differ from phase 6's in {sorted(set(differ) - PATH_FIELDS)}")
    lines = text.splitlines()
    updates = [line for line in lines if line.startswith("#   update ")]
    if "# phase timings" not in text or len(updates) != 1 or "(2 calls," not in updates[0]:
        fail("the .jl run printed no phase timings with 2 update calls")
    # the verbose lines "Snew - Sold = <dH>; ..." and "# CG: <n> solves, <k> iterations"
    dh = [float(line.split("=")[1].split(";")[0]) for line in lines if line.startswith("Snew - Sold")]
    cg = [int(line.split(",")[1].split()[0]) for line in lines if line.startswith("# CG: ")]
    print(f"  .jl run: final plaquette {plaq!r}, dH {dh}, CG iterations {cg} (phase 6: "
          f"{main['plaq']!r}, {main['dH']}, {main['cg']}), {seconds:.3f} s in all, "
          f"wilson_hop_packed {launched} launches, wilson_hop {site} [{STATE['smi']}]", flush=True)
    if plaq != main["plaq"] or dh != main["dH"] or cg != main["cg"]:
        fail("the .jl run's plaquette, dH or CG iterations are not phase 6's bit for bit")
    if launched == 0:
        fail("the .jl run launched wilson_hop_packed no time")
    if site["packed"]:
        fail("the .jl run launched wilson_hop's packed mode")


def _frontend_bicgstab(torch):
    """(b): bicgstab on wilson_window at 16^3x32 in both types, and at 4^4 card against CPU."""
    import numpy as np

    from latticeqcd_torch.ops import fields
    from latticeqcd_torch.ops import solvers
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases

    d = WilsonDirac(kappa=0.12)

    def rsq(v):
        return float(torch.real(torch.sum(v.conj() * v)))

    total = 0
    x64 = None
    for dtype, use_x0 in ((torch.complex64, False), (torch.complex128, False),
                          (torch.complex128, True)):
        u, b, _ = _fields(torch, MAIN, dtype, seed=31)
        x0 = x64.to(dtype) if use_x0 else None
        d.apply(u, b)  # the library's first launch in this type stays out of the timing
        torch.cuda.synchronize()
        before = ww.launches
        t0 = time.time()
        x, it, r = solvers.bicgstab(lambda v: d.apply(u, v), b, x0=x0)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launched = ww.launches - before
        total += launched
        bsq = max(rsq(b), 1.0)
        target = solvers._effective_eps(1e-19, dtype) * bsq
        true = rsq(d.apply(u, x) - b)
        bar = max(target, solvers._VERIFY_FLOOR * bsq) if dtype == torch.complex64 else target
        name = str(dtype).split(".")[-1] + (" from the c64 solution" if use_x0 else "")
        print(f"  bicgstab 16^3x32 {name}: {it} iterations, {seconds:.4f} s "
              f"({1e3 * seconds / max(it, 1):.3f} ms per iteration), wilson_window {launched} "
              f"launches, |r|^2/|b|^2 {float(r) / bsq:.3e}, true |Dx-b|^2/|b|^2 "
              f"{true / bsq:.3e} (target {target / bsq:.1e}, bar {bar / bsq:.1e}) "
              f"[{STATE['smi']}]", flush=True)
        if not (0 < it < 3000) or not float(r) <= target:
            fail(f"bicgstab {name} did not meet its target in {it} iterations")
        if not true <= bar:
            fail(f"bicgstab {name}: the true residual {true} is above {bar}")
        if launched != 2 * it + use_x0:
            fail(f"bicgstab {name} launched wilson_window {launched} times in {it} iterations")
        if dtype == torch.complex64:
            x64 = x
    STATE["launches"].setdefault("wilson_window", {})["bicgstab"] = total

    lat = (4, 4, 4, 4)
    rng = np.random.default_rng(32)
    b_host = rng.standard_normal(lat + (4, 3)) + 1j * rng.standard_normal(lat + (4, 3))
    runs = {}
    for dev in ("cpu", "cuda"):
        u = apply_boundary_phases(fields.hot_start(lat, 3, seed=32, device=dev))
        runs[dev] = solvers.bicgstab(lambda v: d.apply(u, v),
                                     torch.from_numpy(b_host).to(dev), eps=1e-22)
    xc, xg = runs["cpu"][0], runs["cuda"][0].cpu()
    rel = float(torch.linalg.vector_norm(xg - xc) / torch.linalg.vector_norm(xc))
    print(f"  bicgstab 4^4 c128: card {runs['cuda'][1]} iterations, CPU {runs['cpu'][1]}")
    if runs["cuda"][1] != runs["cpu"][1]:
        fail("bicgstab at 4^4 takes other iterations on the card than on the CPU")
    check("bicgstab 4^4 c128 x, card against CPU (relative)", rel, 1e-10)


def _frontend_profile(torch, tmp):
    """(c): one 8^4 Wilson trajectory through the command line with --profile."""
    from latticeqcd_torch.system.wizard import generate_parameters, write_toml

    toml = write_toml(generate_parameters(
        L=(8, 8, 8, 8), beta=6.0, fermion="Wilson", hop=KAPPA, initial="hot", nsteps=1,
        dtau=0.05, md_steps=4, randomseed=3, verboselevel=1, measurements=("Plaquette",)),
        os.path.join(tmp, "profile.toml"))
    trace_dir = os.path.join(tmp, "trace")
    t0 = time.time()
    out = _subprocess(["-m", "latticeqcd_torch.run", toml, "--f32", "--profile", trace_dir],
                      cwd=tmp, timeout=300)
    seconds = time.time() - t0
    for line in out.stdout.splitlines():
        if line.startswith(("#   update ", "#   measure ", "#   save ", "# phase", "# profiler",
                            "final plaquette", "Update:")):
            print(f"  | {line}")
    if out.returncode != 0:
        print(out.stderr[-3000:])
        fail(f"python -m latticeqcd_torch.run --profile exited {out.returncode}")
    path = os.path.join(trace_dir, "trace.json")
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    hop = [e for e in kernels if "wilson_hop_brick_kernel" in e.get("name", "")]
    print(f"  --profile run: {seconds:.1f} s of subprocess, trace {size / 2**20:.1f} MiB, "
          f"{len(events)} events, {len(kernels)} kernel events of which {len(hop)} "
          f"wilson_hop_brick_kernel ({sum(e.get('dur', 0) for e in hop) / 1e3:.3f} ms) "
          f"[{STATE['smi']}]", flush=True)
    if not hop:
        fail("the --profile trace holds no device event of wilson_hop_packed's kernel")


def _frontend_demo(torch, tmp):
    """(d): the heatbath demo's command line."""
    t0 = time.time()
    out = _subprocess(["-m", "latticeqcd_torch.demo", "5"], cwd=tmp, timeout=300)
    lines = out.stdout.splitlines()
    sweeps = [line for line in lines if line.startswith("sweep ")]
    print(f"  demo: exit {out.returncode} in {time.time() - t0:.1f} s, {len(sweeps)} sweep lines; "
          f"{lines[-1] if lines else ''}", flush=True)
    if out.returncode != 0:
        print(out.stderr[-3000:])
        fail(f"python -m latticeqcd_torch.demo exited {out.returncode}")
    if len(sweeps) != 5:
        fail(f"the demo printed {len(sweeps)} sweep lines, not 5")


def phase_frontend(torch):
    print("== 30. the front end on the card: .jl input, bicgstab, --profile, the demo", flush=True)
    import tempfile

    def timed(name, part):
        t0 = time.time()
        part()
        print(f"  {name}: {time.time() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_frontend_") as tmp:
        timed("(a) .jl input", lambda: _frontend_jl(torch, tmp))
        timed("(b) bicgstab", lambda: _frontend_bicgstab(torch))
        # (c) and (d) are subprocesses, each mostly its interpreter's start: run side by side
        with ThreadPoolExecutor(max_workers=2) as pool:
            parts = [pool.submit(timed, "(c) --profile", lambda: _frontend_profile(torch, tmp)),
                     pool.submit(timed, "(d) demo", lambda: _frontend_demo(torch, tmp))]
            for part in parts:
                part.result()


# phase 6's action as a TOML for python -m latticeqcd_torch.multirun, saving every trajectory
GRID_TOML = """\
["Physical setting"]
L = [16, 16, 16, 32]
NC = 3
beta = 6.0
initial = "hot"
update_method = "HMC"
quench = false
Dirac_operator = "Wilson"
hop = 0.141139
r = 1.0
BoundaryCondition = [1, 1, 1, -1]
QPQ = true
dtau = 0.02
MDsteps = 10
Nsteps = {nsteps}
eps = 1e-12
MaxCGstep = 3000
randomseed = 3
verboselevel = 2

["System Control"]
logfile = ""
saveU_format = "NPZ"
saveU_every = 1
saveU_dir = "{d}/saves"

["Measurement set"]
measurement_basedir = "{d}/meas"
measurement_dir = "grid"
measurement_methods = [{{ methodname = "Plaquette", measure_every = 1 }}{methods}]
"""
GRID_FIELDS = {"saveU_format", "saveU_every", "saveU_dir", "logfile", "measurement_basedir",
               "measurement_dir", "measuredir", "Nsteps", "measurement_methods"}


def _face_slab(grid, f, mu, at, lead=0):
    """The slab at global index ``at`` along mu of a global field f, over this block's range
    along the other axes (lattice axes lead..lead + 3), contiguous, axis mu removed."""
    local = [n // p for n, p in zip(f.shape[lead:lead + 4], grid.pes)]
    idx = tuple(at if d == mu else slice(c * n, (c + 1) * n)
                for d, (c, n) in enumerate(zip(grid.coords, local)))
    return f[(slice(None),) * lead + idx].contiguous()


def _block_faces(grid, psi, u_s):
    """A block's face buffers from the global packed field and links, as the exchange
    builds them: {mu: (lo, hi)} of psi and {mu: the -mu neighbour's last slab of u_s[mu]}."""
    faces, links = {}, {}
    for mu in grid.partitioned:
        n = psi.shape[mu] // grid.pes[mu]
        lo, hi = (grid.coords[mu] * n - 1) % psi.shape[mu], ((grid.coords[mu] + 1) * n) % psi.shape[mu]
        faces[mu] = (_face_slab(grid, psi, mu, lo), _face_slab(grid, psi, mu, hi))
        links[mu] = _face_slab(grid, u_s[mu], mu, lo)
    return faces, links


def _grid_kernel(torch):
    """(a): the halo mode on the card, one process: 16^3x32 cut in two along each axis."""
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac.wilson import gaussian_spinor
    from latticeqcd_torch.parallel import mesh

    dev = torch.device("cuda")
    lat = MAIN
    worst = {}
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        bar = BARS[name]
        u, _, g = _fields(torch, lat, dtype, seed=31)
        u_e, u_o = eo_pack.pack_links(u, lat)
        half = (lat[0] // 2,) + lat[1:]
        x = gaussian_spinor(half, 3, dtype=dtype, device=dev, generator=g)
        cot = gaussian_spinor(half, 3, dtype=dtype, device=dev, generator=g)
        g5 = wk.gamma5(cot)
        bitwise = {"forward": True, "d psi": True}
        for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
            ref = wk.wilson_hop_packed(u_t, u_s, x, parity)
            leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, x)]
            grads = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity), leaves, cot)
            _, moving, _ = wk.halo_link_grads(cot, x, parity, {})  # the global field's
            for mu in range(4):
                pes = tuple(2 if d == mu else 1 for d in range(4))
                for rank in (0, 1):
                    grid = mesh.ProcessGrid(pes, lat, rank=rank, device=dev)
                    tag = f"cut {'xyzt'[mu]} block {rank} p={parity} {name}"
                    ut_b, us_b, x_b = (grid.block(t, lead).contiguous()
                                       for t, lead in ((u_t, 1), (u_s, 1), (x, 0)))
                    faces, links = _block_faces(grid, x, u_s)
                    before = wk.halo_launches
                    got = wk.hop_packed_halo(ut_b, us_b, x_b, parity, faces, links)
                    torch.cuda.synchronize()
                    if wk.halo_launches != before + 1:
                        fail("the halo mode of wilson_hop_packed did not launch once")
                    want = grid.block(ref)
                    bitwise["forward"] &= bool(torch.equal(got, want))
                    check(f"halo hop {tag} vs the global kernel", maxdiff(got, want), bar,
                          "wilson_hop_packed")
                    plain = wk.hop_packed_halo_reference(ut_b, us_b, x_b, parity, faces, links)
                    check(f"halo hop {tag} vs plain", maxdiff(got, plain), bar, "wilson_hop_packed")
                    # the backward: d psi is the adjoint hop through the halo mode (u_s forward,
                    # u_t backward links, faces of gamma5 cot); d u_t from the forward's faces;
                    # d u_s with the heads the exchange would bring
                    gfaces, tlinks = _block_faces(grid, g5, u_t)
                    d_psi = wk.gamma5(wk.hop_packed_halo(us_b, ut_b, grid.block(g5).contiguous(),
                                                         1 - parity, gfaces, tlinks))
                    bitwise["d psi"] &= bool(torch.equal(d_psi, grid.block(grads[2])))
                    check(f"halo backward d psi {tag}", maxdiff(d_psi, grid.block(grads[2])), bar,
                          "wilson_hop_packed")
                    d_ut, moving_b, staying = wk.halo_link_grads(grid.block(cot), x_b, parity, faces)
                    n = x.shape[mu] // 2
                    heads = {mu: _face_slab(grid, moving[mu], mu, ((rank + 1) * n) % x.shape[mu])}
                    d_us = wk.scatter_halo(moving_b, staying, heads)
                    check(f"halo backward d u_t {tag}", maxdiff(d_ut, grid.block(grads[0], 1)), bar,
                          "wilson_hop_packed")
                    check(f"halo backward d u_s {tag}", maxdiff(d_us, grid.block(grads[1], 1)), bar,
                          "wilson_hop_packed")
        worst[name] = STATE["err"]["wilson_hop_packed"]
        print(f"  halo mode {name}: bitwise equal to the global kernel's block: forward "
              f"{bitwise['forward']}, d psi {bitwise['d psi']}", flush=True)

        # timing: the halo mode on each cut's block against the kernel without it on a block of
        # the same shape (its own periodic wrap) and on the whole lattice (phase 4's case)
        u_t, u_s = u_e, u_o
        whole = _time_device(torch, lambda: wk.wilson_hop_packed(u_t, u_s, x, 0))
        line = [f"whole 16^3x32 {whole * 1e3:.1f} us"]
        for mu in range(4):
            pes = tuple(2 if d == mu else 1 for d in range(4))
            grid = mesh.ProcessGrid(pes, lat, rank=0, device=dev)
            ut_b, us_b, x_b = (grid.block(t, lead).contiguous()
                               for t, lead in ((u_t, 1), (u_s, 1), (x, 0)))
            faces, links = _block_faces(grid, x, u_s)
            t_halo = _time_device(torch, lambda: wk.hop_packed_halo(ut_b, us_b, x_b, 0, faces, links))
            t_plain = _time_device(torch, lambda: wk.wilson_hop_packed(ut_b, us_b, x_b, 0))
            face_bytes = faces[mu][0].numel() * faces[mu][0].element_size()
            line.append(f"cut {'xyzt'[mu]}: halo {t_halo * 1e3:.1f} us, no halo on the block "
                        f"{t_plain * 1e3:.1f} us, {face_bytes} B per spinor face message")
        print(f"  timing {name} (cold is not separated here: one input set): " + "; ".join(line)
              + f" [{STATE['smi']}]", flush=True)


def _grid_draws(torch):
    """The cost of the global draws: Draws.sample of phase 6's action at 16^3x32 complex64 on
    one block of the grid (1, 1, 1, 2) (the global normals, then the block kept) against the
    block's own shapes drawn without a grid."""
    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.parallel import mesh
    from latticeqcd_torch.updates.hmc import HMC, Draws

    dev = torch.device("cuda")
    grid = mesh.ProcessGrid((1, 1, 1, 2), MAIN, rank=0, device=dev)
    with mesh.use_grid(grid):
        u = fields.hot_start(MAIN, 3, seed=3, dtype=torch.complex64, device=dev)
    hmc = HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.02, md_steps=10,
              fermi_action=WilsonFermiAction(WilsonDirac(kappa=KAPPA)))
    gen = torch.Generator(device=dev).manual_seed(3)
    times = {"global": [], "local": []}
    for label in ("global", "local", "local", "global") * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh.use_grid(grid if label == "global" else None):
            draws = Draws.sample(hmc, u, gen)
            if label == "global":
                draws = draws.block(grid)
        torch.cuda.synchronize()
        times[label].append(time.perf_counter() - t0)
    nbytes = 4 * (2 * 4 * math.prod(MAIN) * 9 + 2 * math.prod(MAIN) // 2 * 12)
    print(f"  global draws at 16^3x32 complex64: {nbytes / 1e6:.1f} MB of normals per trajectory "
          f"on each rank; {statistics.median(times['global']) * 1e3:.3f} ms (sample and keep the "
          f"block) against {statistics.median(times['local']) * 1e3:.3f} ms for the block's own "
          f"shapes [{STATE['smi']}]", flush=True)


def _multirun(tmp, tag, nsteps, dtype_flag, pes, backend, timeout=300, toml=None, methods=""):
    """python -m latticeqcd_torch.multirun on GRID_TOML with the measurement methods
    ``methods`` beside the plaquette (or on ``toml``, written in the run's directory tmp/tag
    already): one rank per block of the grid pes, each with --report; returns (the reports,
    the run's directory). Every process is killed if the group does not finish in time."""
    import socket

    import numpy as np

    nprocs = math.prod(pes)
    d = os.path.join(tmp, tag)
    if toml is None:
        os.makedirs(d)
        toml = os.path.join(d, "params.toml")
        with open(toml, "w") as f:
            f.write(GRID_TOML.format(nsteps=nsteps, d=d, methods=methods))
    report = os.path.join(d, "report")
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmds = []
    if nprocs == 1:
        cmds.append([toml, "--device", "cuda:0"])
    else:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for rank in range(nprocs):
            cmds.append([toml, *map(str, pes), "--coordinator", f"127.0.0.1:{port}",
                         "--nprocs", str(nprocs), "--procid", str(rank), "--backend", backend,
                         "--device", f"cuda:{rank if backend == 'nccl' else 0}"])
    procs = [subprocess.Popen([sys.executable, "-m", "latticeqcd_torch.multirun", *c, dtype_flag,
                               "--report", report], cwd=d, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(out[-3000:])
            print(err[-3000:])
            fail(f"multirun {tag} rank {rank} exited {p.returncode}")
    reports = []
    for rank in range(nprocs):
        with open(os.path.join(report, f"rank{rank}.json")) as f:
            rep = json.load(f)
        rep["u"] = np.load(os.path.join(report, f"rank{rank}_u.npy"))
        reports.append(rep)
    return reports, d


def _one_process(torch, toml, dtype):
    """(history, final links, seconds) of the run of ``toml`` on one process in this one,
    nothing saved or measured."""
    import dataclasses

    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import construct_params_from_toml

    p = construct_params_from_toml(toml, make_dirs=False)
    p = dataclasses.replace(p, saveU_format=None, measurement_methods=[], verboselevel=0)
    history, final = [], {}
    t0 = time.time()
    run_lqcd_params(p, make_dirs=False, dtype=dtype, device="cuda:0", history=history,
                    final=final)
    return history, final["u"], time.time() - t0


def _grid_runs(torch, tmp, backend, pes=(1, 1, 1, 2)):
    """(b), or (c) under nccl: the grid pes through multirun, a complex128 trajectory against
    one process (in this one), then phase 6's complex64 path for 1 trajectory with phase 32's
    three fermionic measurements (checked by _grid_measured)."""
    import dataclasses

    import numpy as np

    from latticeqcd_torch.parallel import mesh
    from latticeqcd_torch.system.params import construct_params_from_toml

    n = math.prod(pes)
    label = f"{backend}, {n} ranks {pes}"
    t0 = time.time()
    two, d2 = _multirun(tmp, f"c128_{backend}_{n}", 1, "--f64", pes, backend)
    one, u_one, _ = _one_process(torch, os.path.join(d2, "params.toml"), torch.complex128)
    dh = [rep["history"][0]["dH"] for rep in two]
    if len({float(v).hex() for v in dh}) != 1:
        fail(f"the ranks' dH differ: {dh}")
    ddh = abs(dh[0] - one[0]["dH"])
    a = np.load(os.path.join(d2, "saves", "conf_00000001.npz"))["u"]
    print(f"  ({label}) 16^3x32 complex128 trajectory: dH {dh[0]!r} (one process "
          f"{one[0]['dH']!r}), accepted {two[0]['history'][0]['accepted']}; "
          f"{time.time() - t0:.1f} s for both runs", flush=True)
    check(f"({label}) complex128 trajectory |ddH| against one process", ddh, 1e-8)
    check(f"({label}) complex128 trajectory max|dU| against one process",
          maxdiff(torch.from_numpy(a).to(u_one.device), u_one), 1e-10)

    t0 = time.time()
    reps, d = _multirun(tmp, f"c64_{backend}_{n}", 1, "--f32", pes, backend,
                        methods=GRID_METHODS)
    got = construct_params_from_toml(os.path.join(d, "params.toml"), make_dirs=False)
    differ = sorted(k for k, v in dataclasses.asdict(_wilson_path_params()).items()
                    if getattr(got, k) != v)
    if set(differ) - GRID_FIELDS:
        fail(f"the grid run's Params differ from phase 6's in {sorted(set(differ) - GRID_FIELDS)}")
    for i in range(len(reps[0]["history"])):
        dhs = [rep["history"][i]["dH"] for rep in reps]
        if not all(math.isfinite(v) for v in dhs) or len({float(v).hex() for v in dhs}) != 1:
            fail(f"trajectory {i + 1}: the ranks' dH are not finite and equal: {dhs}")
    for rep in reps:
        worst = max(c["rsq"] / c["target"] for rec in rep["history"] for c in rec["cg"])
        if worst > 1.0:
            fail(f"rank {rep['rank']}: a CG returned a verified residual above its target")
        if not 0.0 < rep["plaquette"] < 1.0:
            fail(f"rank {rep['rank']}: plaquette {rep['plaquette']} outside (0, 1)")
        if rep["launches"]["wilson_hop_packed_halo"] == 0:
            fail(f"rank {rep['rank']}: the halo mode of wilson_hop_packed never launched")
        if rep["launches"]["wilson_hop_packed"]:
            fail(f"rank {rep['rank']}: a hop ran without the halo mode under the grid")
    saved = np.load(os.path.join(d, "saves", "conf_00000001.npz"))["u"]
    gathered = np.empty_like(saved)
    for rep in reps:
        grid = mesh.ProcessGrid(pes, MAIN, rank=rep["rank"])
        gathered[(slice(None),) + tuple(slice(o, o + m) for o, m in zip(grid.origin, grid.local))] = \
            rep["u"]
    if saved.tobytes() != gathered.tobytes():
        fail("the saved configuration is not the ranks' blocks bit for bit")
    main = STATE["wilson_main"]
    halo = [rep["launches"]["wilson_hop_packed_halo"] for rep in reps]
    STATE["launches"].setdefault("wilson_hop_packed", {})[f"grid path, {label} (halo)"] = sum(halo)
    for i, rec in enumerate(reps[0]["history"]):
        cg = sum(c["iterations"] for c in rec["cg"])
        print(f"  ({label}) trajectory {rec['itrj']}: {rec['seconds']:.3f} s (phase 6: "
              f"{main['seconds'][i]:.3f} s)  CG iterations {cg} (phase 6: {main['cg'][i]})  dH "
              f"{rec['dH']:.6f} (phase 6: {main['dH'][i]:.6f})  accepted {rec['accepted']} "
              f"[{STATE['smi']}]", flush=True)
    _grid_measured(reps, label)
    print(f"  ({label}) final plaquette {reps[0]['plaquette']!r} (phase 6 after its 2 "
          f"trajectories {main['plaq']!r}); "
          f"halo launches per rank {halo}; the saved configuration equals the gathered blocks "
          f"bit for bit; {time.time() - t0:.1f} s for the run", flush=True)


def phase_grid(torch):
    print("== 31. the process grid: the halo mode of wilson_hop_packed, 2 ranks on the card",
          flush=True)
    import tempfile

    if "wilson_main" not in STATE:
        fail("phase 31 compares with phase 6's run: run phase_main_path first")
    t0 = time.time()
    _grid_kernel(torch)
    _grid_draws(torch)
    print(f"  (a) halo mode and draws: {time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid_") as tmp:
        t0 = time.time()
        _grid_runs(torch, tmp, "gloo")
        print(f"  (b) 2 ranks, gloo, one card: {time.time() - t0:.1f} s", flush=True)
        if torch.cuda.device_count() >= 2:
            t0 = time.time()
            _grid_runs(torch, tmp, "nccl")
            print(f"  (c) 2 ranks, nccl, 2 cards: {time.time() - t0:.1f} s", flush=True)
        else:
            print(f"  (c) nccl: not run, this machine has {torch.cuda.device_count()} card",
                  flush=True)
    # (d) the group of ranks that phases 31-35 share, started beside phases 20-26 with every
    # run of theirs; this phase's is a Wilson trajectory at r = 0.5
    t0 = time.time()
    _grid_group_runs(torch, "gloo", GRID_R_RUNS)
    print(f"  (d) 2 ranks, gloo, one card: {time.time() - t0:.1f} s (the wait for the shared "
          "group included)", flush=True)
    if torch.cuda.device_count() >= 2:
        t0 = time.time()
        _grid_group_runs(torch, "nccl", GRID_R_RUNS)
        print(f"  (d) 2 ranks, nccl, 2 cards: {time.time() - t0:.1f} s", flush=True)


# ------------------------------------------- 32. staggered, clover and measurements on the grid


def _halo_kernels(torch):
    """(a): the halo modes of staggered_w and wilson_window on the card, one process: every
    block of 16^3x32 cut in two along each axis, against the block of the global kernel's
    output and the plain halo version; then the t cut's block against mask 0 on a block of
    the same shape."""
    from latticeqcd_torch.ops.dirac import eo_pack
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.ops.dirac.wilson import gaussian_spinor
    from latticeqcd_torch.parallel import mesh

    dev = torch.device("cuda")
    lat = MAIN
    half = (lat[0] // 2,) + lat[1:]
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        bar = BARS[name]
        u, psi, g = _fields(torch, lat, dtype, seed=41)
        u_e, u_o = eo_pack.pack_links(u, lat)
        x = gaussian_spinor(half, 3, nspin=1, dtype=dtype, device=dev, generator=g)
        d1 = sk.staggered_hop_packed(u_o, u_e, x, 1)
        # (kernel, what, forward links, backward links, source, global output, the block's call)
        cases = [("staggered_w", f"hop p={p}", ut, us, x, sk.staggered_hop_packed(ut, us, x, p),
                  lambda ut_b, us_b, s_b, f, l, grid, p=p: sk.hop_packed_halo(ut_b, us_b, s_b, p,
                                                                              f, l))
                 for p, (ut, us) in ((0, (u_e, u_o)), (1, (u_o, u_e)))]
        cases.append(("staggered_w", "W (axpy launch on the faces of d1)", u_e, u_o, d1,
                      sk.staggered_w(u_e, u_o, x, MASS),
                      lambda ut_b, us_b, s_b, f, l, grid: sk.hop_packed_halo(
                          ut_b, us_b, s_b, 0, f, l, phi=grid.block(x).contiguous(), mass=MASS)))
        cases.append(("wilson_window", "D", u, u, psi, ww.wilson_window(u, psi, KAPPA),
                      lambda ut_b, us_b, s_b, f, l, grid: ww.dslash_halo(ut_b, s_b, KAPPA, f, l)))
        bitwise = {}
        for kernel, what, ut, us, src, ref, call in cases:
            module = ww if kernel == "wilson_window" else sk
            for mu in range(4):
                pes = tuple(2 if d == mu else 1 for d in range(4))
                for rank in (0, 1):
                    grid = mesh.ProcessGrid(pes, lat, rank=rank, device=dev)
                    tag = f"{kernel} {what} cut {'xyzt'[mu]} block {rank} {name}"
                    ut_b, us_b = grid.block(ut, 1).contiguous(), grid.block(us, 1).contiguous()
                    s_b = grid.block(src).contiguous()
                    faces, links = _block_faces(grid, src, us)
                    before = module.halo_launches
                    got = call(ut_b, us_b, s_b, faces, links, grid)
                    torch.cuda.synchronize()
                    if module.halo_launches != before + 1:
                        fail(f"the halo mode of {kernel} did not launch once")
                    want = grid.block(ref)
                    key = f"{kernel} {what.split(' ')[0]}"
                    bitwise[key] = bitwise.get(key, True) and bool(torch.equal(got, want))
                    check(f"halo {tag} vs the global kernel", maxdiff(got, want), bar, kernel)
                    if kernel == "wilson_window":
                        plain = wk.dslash_halo_reference(ut_b, s_b, KAPPA, faces, links)
                    else:
                        plain = sk.hop_packed_halo_reference(ut_b, us_b, s_b, int(what == "hop p=1"),
                                                             faces, links)
                        if what.startswith("W"):
                            plain = MASS ** 2 * grid.block(x) - plain
                    check(f"halo {tag} vs plain", maxdiff(got, plain), bar, kernel)
        print(f"  halo modes {name}: bitwise equal to the global kernel's block: {bitwise}",
              flush=True)

        # timing: the t cut's 16^3x16 block in the halo mode against mask 0 on the same shape
        grid = mesh.ProcessGrid((1, 1, 1, 2), lat, rank=0, device=dev)
        ue_b, uo_b = grid.block(u_e, 1).contiguous(), grid.block(u_o, 1).contiguous()
        u_b, x_b, psi_b = grid.block(u, 1).contiguous(), grid.block(x).contiguous(), \
            grid.block(psi).contiguous()
        xf, xl = _block_faces(grid, x, u_o)
        _, el = _block_faces(grid, x, u_e)
        df, dl = _block_faces(grid, d1, u_o)
        d1_b = grid.block(d1).contiguous()
        pf, pl = _block_faces(grid, psi, u)
        rows = [
            ("staggered hop", lambda: sk.hop_packed_halo(ue_b, uo_b, x_b, 0, xf, xl),
             lambda: sk.staggered_hop_packed(ue_b, uo_b, x_b, 0), xf),
            ("staggered W", lambda: (sk.hop_packed_halo(uo_b, ue_b, x_b, 1, xf, el),
                                     sk.hop_packed_halo(ue_b, uo_b, d1_b, 0, df, dl, phi=x_b,
                                                        mass=MASS)),
             lambda: sk.staggered_w(ue_b, uo_b, x_b, MASS), df),
            ("window D", lambda: ww.dslash_halo(u_b, psi_b, KAPPA, pf, pl),
             lambda: ww.wilson_window(u_b, psi_b, KAPPA), pf),
        ]
        line = []
        for label, halo, plain, faces in rows:
            t_halo, t_plain = _time_device(torch, halo), _time_device(torch, plain)
            STATE.setdefault("halo_timing", {})[(label, name)] = (t_halo, t_plain)
            face_bytes = faces[3][0].numel() * faces[3][0].element_size()
            line.append(f"{label}: halo {t_halo * 1e3:.2f} us, mask 0 {t_plain * 1e3:.2f} us "
                        f"({100 * (t_halo / t_plain - 1):+.1f}%), {face_bytes} B per t face message")
        xcut = mesh.ProcessGrid((2, 1, 1, 1), lat, rank=0, device=dev)
        xs = {k: _block_faces(xcut, f, uu)[0][0][0] for k, f, uu in (("staggered", x, u_o),
                                                                     ("window", psi, u))}
        print(f"  warm block 16^3x16 (one input set, CUDA graphs) {name}: " + "; ".join(line)
              + "; x cut face messages: " + ", ".join(f"{k} {t.numel() * t.element_size()} B"
                                                       for k, t in xs.items())
              + f" [{STATE['smi']}]", flush=True)


# phase 32's three measurements, one operator each, carried by phase 31's complex64 run
GRID_METHODS = (
    ', { methodname = "Chiral_condensate", Nr = 2, eps = 1e-10, fermion_parameters = '
    '{ Dirac_operator = "Staggered", mass = 0.5, Nf = 4 } }'
    ', { methodname = "Pion_correlator", eps = 1e-10, fermion_parameters = '
    '{ Dirac_operator = "WilsonClover", hop = 0.12, Clover_coefficient = 1.0 } }'
    ', { methodname = "Dirac_spectrum", Neig = 4, Nlanczos = 24, fermion_parameters = '
    '{ Dirac_operator = "Wilson", hop = 0.12 } }')


def _grid_measured(reps, label):
    """Phase 32's check of the three fermionic measurements of a grid run (phase 31's c64
    path carries them): the same bit for bit on every rank, finite, the correlator positive
    and the Ritz values ascending and positive."""
    got = [rep["history"][0]["measured"] for rep in reps]
    names = ("Chiral_condensate", "Pion_correlator", "Dirac_spectrum")
    if any(set(names) - set(m) for m in got):
        fail(f"the grid run measured {sorted(got[0])}, not {names}")
    for m in got[1:]:
        if json.dumps(m, sort_keys=True) != json.dumps(got[0], sort_keys=True):
            fail(f"the ranks' measurements differ: {got}")
    pbp, cpi, lam = (got[0][k] for k in names)
    if not (all(math.isfinite(v) for v in cpi) and min(cpi) > 0 and min(lam) > 0
            and lam == sorted(lam) and math.isfinite(pbp[0])):
        fail(f"the measurements are not finite and ordered: {got[0]}")
    STATE["checks"] += 1
    for kernel in ("staggered_w", "wilson_window"):
        n = sum(rep["launches"][f"{kernel}_halo"] for rep in reps)
        if n == 0:
            fail(f"the grid's measurements never launched {kernel}'s halo mode")
        STATE["launches"].setdefault(kernel, {})[f"grid measurements, {label} (halo)"] = n
    print(f"  ({label}) complex64 trajectory with phase 32's three measurements, the same bit for "
          f"bit on every rank: pbp {pbp[0]!r} (staggered), C(0..3) {cpi[:4]} (clover), lowest "
          f"Ritz values {lam} (Wilson D^dag D)", flush=True)


def phase_grid_fermions(torch):
    print("== 32. the process grid: staggered, clover and the measurements (halo modes of "
          "staggered_w and wilson_window), 2 ranks on the card", flush=True)

    t0 = time.time()
    _halo_kernels(torch)
    print(f"  (a) halo modes: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    _grid_group_runs(torch, "gloo", GRID2_RUNS)
    print(f"  (b) 2 ranks, gloo, one card (the shared group's runs): {time.time() - t0:.1f} s",
          flush=True)
    if torch.cuda.device_count() >= 2:
        t0 = time.time()
        _grid_group_runs(torch, "nccl", GRID2_RUNS)
        print(f"  (c) 2 ranks, nccl, 2 cards: {time.time() - t0:.1f} s", flush=True)
    else:
        print(f"  (c) nccl: not run, this machine has {torch.cuda.device_count()} card",
              flush=True)


# ------------------------------- 33. Hasenbusch, domain wall and the heatbath on the grid

# the domain-wall trajectory's L5 on the grid, and the measurements' (phase 23 runs 16 on one
# card; two gloo ranks on one card pay about 5 ms per slice exchange, so neither 16 nor 8 fits
# the phase's time, PERF.md sec. 6)
GRID3_DW_L5, GRID3_DW_MEASURE_L5 = 4, 2
GRID3_DW = {"Dirac_operator": "Domainwall", "Domainwall_m": DW_MASS, "Domainwall_M": DW_M5,
            "Domainwall_L5": GRID3_DW_MEASURE_L5}
GRID3_DW_METHODS = [
    {"methodname": "Chiral_condensate", "Nr": 1, "eps": 1e-10, "fermion_parameters": GRID3_DW},
    {"methodname": "Pion_correlator", "eps": 1e-10, "fermion_parameters": GRID3_DW},
    {"methodname": "Dirac_spectrum", "Neig": 4, "Nlanczos": 24, "fermion_parameters": GRID3_DW},
]
# phases 32 and 33's runs on the grid, one group of ranks per phase: tag -> (what it is, its
# type, the halo kernels it must launch)
GRID2_RUNS = {
    "staggered_nf4": ("staggered Nf=4", "complex128", ("staggered_w",)),
    "staggered_nf2": ("staggered Nf=2 RHMC", "complex128", ("staggered_w",)),
    "clover": ("clover HMC", "complex128", ("wilson_window",)),
}
GRID3_RUNS = {
    "domainwall": (f"domain-wall HMC (L5 = {GRID3_DW_L5})", "complex128",
                   ("wilson_hop_packed",)),
    "hasenbusch_clover": ("clover Hasenbusch + SW", "complex128", ("wilson_window",)),
    "hasenbusch": ("Hasenbusch (csw = 0)", "complex128", ("wilson_hop_packed",)),
    "heatbath": ("heatbath + 3 overrelaxations", "complex64", ()),
}
# phase 34's: stout, the self-learning updaters and Fileloading. SLHMC's gluonic MD leaves the
# fermion action out, so its 16^3x32 trajectory may reject (phase 25): the decision is compared
GRID4_RUNS = {
    "stout": ("stout-smeared Wilson HMC (2 layers, rho 0.1)", "complex128",
              ("wilson_hop_packed",)),
    "slhmc": ("SLHMC (Wilson, plaquette + rectangle basis)", "complex128",
              ("wilson_hop_packed",)),
    "slmc": ("quenched SLMC", "complex64", ()),
    "fileloading": ("Fileloading over 2 NPZ files", "complex128", ()),
    "integratedhb": ("IntegratedHB, staggered dense log det at 4^4", "complex128",
                     ("staggered_w",)),
}
# phase 31's run on the shared group: Wilson HMC at r = 0.5 (the packed hop's r mode in its
# halo mode)
GRID_R_RUNS = {
    "wilson_r": (f"Wilson HMC at r = {R_MODE}", "complex128",
                 ("wilson_hop_packed", "wilson_hop_packed_r")),
}
# every run of phases 31-34, on one group of ranks started once (_grid_group)
GRID_RUNS = {**GRID_R_RUNS, **GRID2_RUNS, **GRID3_RUNS, **GRID4_RUNS}
# the runs held to one card by their links and the generator's state, not by an HMC dH
GRID_EXACT = ("heatbath", "slmc", "fileloading", "integratedhb")
GRID4_CONFS = "grid4_confs"
HALO_KERNELS = ("wilson_hop_packed", "wilson_window", "staggered_w")
R_KERNELS = ("wilson_hop_packed_r", "wilson_window_r")


def _grid_params(tag, tmp=None):
    """The Params of a run of phase 31, 32, 33 or 34: 16^3x32 from a hot start, one step; an
    HMC trajectory of 2 MD steps of 0.005 (dH well under 1, so the evolved links are the
    ones compared): phase 6's Wilson action at r = 0.5, phase 10's staggered actions, phase
    27's clover action, phase 33's, and phase 34's (Fileloading reads the NPZ files saved
    under ``tmp``; IntegratedHB runs at 4^4, the dense log det's size)."""
    from latticeqcd_torch.system.params import Params

    base = dict(L=MAIN, NC=3, initial="hot", BoundaryCondition=(1, 1, 1, -1), QPQ=True,
                Nsteps=1, randomseed=5, verboselevel=0, MaxCGstep=3000)
    hmc = dict(update_method="HMC", quench=False, dtau=0.005, MDsteps=2)
    if tag == "wilson_r":
        return Params(**base, **hmc, eps=1e-16, beta=6.0, Dirac_operator="Wilson", hop=KAPPA,
                      r=R_MODE)
    if tag == "stout":
        return Params(**base, **hmc, eps=1e-16, beta=6.0, Dirac_operator="Wilson", hop=KAPPA,
                      r=1.0, smearing_for_fermion="stout", stout_numlayers=2, stout_rho=[0.1])
    if tag == "slhmc":
        return Params(**dict(base, update_method="SLHMC", quench=False, dtau=0.005, MDsteps=2,
                             eps=1e-16, beta=6.0, Dirac_operator="Wilson", hop=KAPPA, r=1.0,
                             couplinglist=["plaquette", "rectangular"], couplingcoeff=[],
                             beta_eff=[6.0, 0.0], firstlearn=1))
    if tag == "slmc":
        return Params(**base, beta=6.0, update_method="SLMC", quench=True, beta_eff=5.5,
                      firstlearn=1)
    if tag == "fileloading":
        return Params(**dict(base, Nsteps=0), beta=6.0, update_method="Fileloading",
                      loadU_format="NPZ", loadU_dir=os.path.join(tmp, GRID4_CONFS),
                      measurement_methods=[{"methodname": "Plaquette"},
                                           {"methodname": "Energy_density"}])
    if tag == "integratedhb":
        return Params(**dict(base, L=(4, 4, 4, 4)), beta=5.7, update_method="IntegratedHB",
                      quench=False, Dirac_operator="Staggered", mass=MASS, Nf=4)
    if tag.startswith("staggered"):
        return Params(**base, **hmc, eps=1e-16, beta=5.7, Dirac_operator="Staggered", mass=MASS,
                      Nf=4 if tag == "staggered_nf4" else 2)
    if tag == "clover":
        return Params(**base, **hmc, eps=1e-16, beta=CLOVER_BETA, Dirac_operator="WilsonClover",
                      hop=CLOVER_KAPPA, Clover_coefficient=CLOVER_CSW, r=1.0)
    if tag == "domainwall":
        return Params(**base, **hmc, eps=1e-16, beta=6.0, Dirac_operator="Domainwall",
                      Domainwall_m=DW_MASS, Domainwall_M=DW_M5, Domainwall_L5=GRID3_DW_L5)
    if tag.startswith("hasenbusch"):
        clover = tag == "hasenbusch_clover"
        # the final action's solves to |r|^2 / |b|^2 = 1e-20: at 1e-16 their truncation leaves
        # about 1e-8 of the clover action (3e6) undetermined, the size of the dH bar
        return Params(**base, **hmc, eps=1e-20, beta=CLOVER_BETA,
                      Dirac_operator="WilsonClover" if clover else "Wilson", hop=CLOVER_KAPPA,
                      Clover_coefficient=CLOVER_CSW if clover else 0.0, r=1.0, hasenbusch=True,
                      hasenbusch_mu=0.5, SextonWeingargten=clover, N_SextonWeingargten=2)
    return Params(**base, beta=6.0, update_method="Heatbath", quench=True, useOR=True, numOR=3)


def _all_counts():
    """Every Wilson and staggered kernel's launches, each halo mode and r mode apart."""
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    return {"wilson_hop_packed": wk.launches, "wilson_hop_packed_halo": wk.halo_launches,
            "wilson_window": ww.launches, "wilson_window_halo": ww.halo_launches,
            "staggered_w": sk.launches, "staggered_w_halo": sk.halo_launches,
            # the r mode's launches, counted in the above as well
            "wilson_hop_packed_r": wk.r_launches, "wilson_hop_packed_r_halo": wk.r_halo_launches,
            "wilson_window_r": ww.r_launches, "wilson_window_r_halo": ww.r_halo_launches}


def _zero_all_counts():
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    wk.launches = wk.halo_launches = ww.launches = ww.halo_launches = 0
    wk.r_launches = wk.r_halo_launches = ww.r_launches = ww.r_halo_launches = 0
    sk.launches = sk.halo_launches = sk.w_launches = sk.fused_launches = 0
    wk.chain_halo_launches = sk.chain_halo_launches = ww.chain_halo_launches = 0
    ww.chain_launches = 0
    wk.site_launches.update(full=0, packed=0)


def _grid_step(torch, tag, device, grid=None, tmp=None):
    """One run of phase 31, 32, 33 or 34 through run_lqcd_params (on ``grid`` if given, or on
    a grid of its processes over the run's own lattice) with the launches counted from 0:
    (its record for the JSON report, the final links gathered on rank 0 as numpy (None
    elsewhere), the final links' block)."""
    import hashlib

    from latticeqcd_torch.parallel import mesh
    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.updates.hmc import HMC

    _, dtype_name, _ = GRID_RUNS[tag]
    params = _grid_params(tag, tmp)
    if grid is not None and tuple(grid.lattice) != tuple(params.L):
        grid = mesh.make_process_grid(grid.pes, params.L, device)
    history, final, parts = [], {}, []
    step = HMC.step

    def stepped(self, u, generator=None, draws=None):  # the trajectory's action parts
        out = step(self, u, generator, draws)
        parts.append({k: out[1][k] for k in ("sp_old", "sp_new", "sg_old", "sg_new", "sf_old",
                                             "sf_new")})
        return out

    torch.cuda.synchronize(device)
    _zero_all_counts()
    t0 = time.time()
    with mock.patch.object(HMC, "step", stepped):
        plaq = run_lqcd_params(params, make_dirs=False,
                               dtype=getattr(torch, dtype_name), device=device, grid=grid,
                               history=history, final=final)
    torch.cuda.synchronize(device)
    rec = {"seconds_run": time.time() - t0, "plaq": plaq, "launches": _all_counts(),
           "parts": parts,
           "generator": hashlib.sha256(final["generator"].get_state().numpy().tobytes()).hexdigest(),
           "history": [{"seconds": r["seconds"], "dH": r["dH"], "accepted": r["accepted"],
                        "iterations": [c["iterations"] for c in r["cg"]],
                        "worst": max((c["rsq"] / c["target"] for c in r["cg"]), default=0.0),
                        "beta_eff": r["beta_eff"], "measured": r["measured"]}
                       for r in history]}
    u = final["u"]
    host = mesh.to_host_global(u, lead=1, grid=grid) if grid is not None else u.cpu().numpy()
    return rec, host, u


def _grid_extra(torch, tag, u, rec):
    """What runs on a run's final links (under the active grid, if any): the domain-wall
    measurements and one Shat^dag Shat's launches; one heatbath and one overrelaxation sweep
    timed."""
    from latticeqcd_torch.measurements.scheduler import MeasurementSet
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.wilson import apply_boundary_phases
    from latticeqcd_torch.parallel import mesh
    from latticeqcd_torch.updates.heatbath import Heatbath

    dev = u.device
    if tag == "domainwall":
        _zero_all_counts()
        rec["measured"], rec["measure_seconds"] = {}, {}
        for m in MeasurementSet.from_methods(GRID3_DW_METHODS).measurements:
            torch.cuda.synchronize(dev)
            t0 = time.time()
            m.measure(u, 1)
            torch.cuda.synchronize(dev)
            rec["measure_seconds"][m.name] = time.time() - t0
            value = m.value
            if m.name == "Chiral_condensate":
                value = [value[0], *value[1]]
            rec["measured"][m.name] = [float(v) for v in value]
        rec["measure_launches"] = _all_counts()
        d = DomainwallDirac(DW_MASS, DW_M5, GRID3_DW_L5)  # the trajectory's operator
        ueo = d.packed_links(apply_boundary_phases(u, d.bc))
        gen = torch.Generator(device=dev).manual_seed(6)
        shape = (GRID3_DW_L5, u.shape[1] // 2) + tuple(u.shape[2:5]) + (4, 3)
        x = torch.complex(*(mesh.randn_block(shape, 1, gen, u.real.dtype, dev) for _ in range(2)))
        d.apply_schur_ddag_d(ueo, x)  # the links' faces exchanged once
        before = _all_counts()
        d.apply_schur_ddag_d(ueo, x)
        torch.cuda.synchronize(dev)
        rec["per_op"] = {k: v - before[k] for k, v in _all_counts().items()}
    if tag == "heatbath":
        hb = Heatbath(action=ga.wilson_gauge_action(3, 6.0))
        gen = torch.Generator(device=dev).manual_seed(7)
        for what, fn in (("sweep", lambda: hb.sweep(u, gen)), ("overrelax", lambda: hb.overrelax(u))):
            torch.cuda.synchronize(dev)
            t0 = time.time()
            fn()
            torch.cuda.synchronize(dev)
            rec[f"{what}_seconds"] = time.time() - t0


def _grid_rank(argv):
    """A rank of the group of phases 31-35 (started by _grid_group as its own process):
    each run named in argv on the grid, then phase 35's batched runs (_grid5_rank), its
    report written as <tmp>/rank<r>.json, rank 0 also writing each run's gathered links as
    <tmp>/<tag>_u.npy."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from latticeqcd_torch.parallel import mesh

    rank, nprocs, port, backend, tmp = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    pes = tuple(int(p) for p in argv[5].split(","))
    tags = [t for t in argv[6].split(",") if t]
    mesh.init_process_grid(backend, f"127.0.0.1:{port}", nprocs, rank, timeout_s=600)
    device = torch.device(f"cuda:{rank if backend == 'nccl' else 0}")
    out = {}
    try:
        grid = mesh.make_process_grid(pes, MAIN, device)
        for tag in tags:
            rec, host, u = _grid_step(torch, tag, device, grid, tmp)
            if host is not None:
                np.save(os.path.join(tmp, f"{tag}_u.npy"), host)
            with mesh.use_grid(grid):
                _grid_extra(torch, tag, u, rec)
            out[tag] = rec
        if pes == (1, 1, 1, 2):  # phase 35's batched runs
            out["batched"] = _grid5_rank(torch, device, tmp, rank, nprocs)
    finally:
        mesh.close_process_grid()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _start_grid_group(torch, backend, pes=(1, 1, 1, 2)):
    """Start the one group of ranks of phases 31-35 (per backend) and return at once: a
    process each, all at once, to run every run of GRID_RUNS and phase 35's batched runs on
    the grid pes, each writing its output to a log file in the group's directory (removed
    when the script ends). _grid_group joins it."""
    import atexit
    import shutil
    import socket
    import tempfile

    key = ("grid group started", backend, pes)
    if key in STATE:
        return
    n = math.prod(pes)
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_grid_{backend}_")
    atexit.register(shutil.rmtree, tmp, True)
    _grid_confs(torch, tmp)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as c; "
            "c._grid_rank(sys.argv[1:])")
    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n), str(port), backend, tmp,
                               ",".join(map(str, pes)), ",".join(GRID_RUNS)], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    for log in logs:
        log.close()

    def stop():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    STATE[key] = (procs, tmp, time.time(), stop)


def _grid_group(torch, backend, pes=(1, 1, 1, 2)):
    """The one group of ranks of phases 31-35 (per backend), joined: started here unless
    _start_grid_group started it beside earlier phases; (the ranks' reports, the group's
    directory, its seconds) kept for the phases that compare them."""
    key = ("grid group", backend, pes)
    if key in STATE:
        return STATE[key]
    _start_grid_group(torch, backend, pes)
    procs, tmp, t0, stop = STATE[("grid group started", backend, pes)]
    n = len(procs)
    t_join = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(60.0, 1000.0 - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        stop()
        fail("the grid group did not finish within 1000 s of its start")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                print(f.read()[-6000:])
            fail(f"the grid group's rank {r} exited {p.returncode}")
    ends = [os.path.getmtime(os.path.join(tmp, f"rank{r}.json")) for r in range(n)]
    t_group = max(ends) - t0
    reps = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    print(f"  ({backend}, {n} ranks {pes}) the group of phases 31-35: {n} processes ran "
          f"{len(GRID_RUNS)} runs and phase 35's in {t_group:.1f} s; this process waited "
          f"{time.time() - t_join:.1f} s for it", flush=True)
    STATE[key] = (reps, tmp, t_group)
    return STATE[key]


def phase_grid_start(torch):
    print("== the shared group of phases 31-35: two gloo ranks start on the card beside phases "
          "20, 22, 24 and 26", flush=True)
    _start_grid_group(torch, "gloo")


def _grid_group_runs(torch, backend, runs, pes=(1, 1, 1, 2)):
    """Each run of ``runs`` from the shared group's reports (_grid_group, started at the
    first call), held against the same run on one card in this process."""
    import numpy as np

    reps, tmp, _ = _grid_group(torch, backend, pes)
    n = math.prod(pes)
    label = f"{backend}, {n} ranks {pes}"
    for tag, (what, dtype_name, halo) in runs.items():
        got = [rep[tag] for rep in reps]
        for key in ("history", "plaq", "generator", "measured"):
            vals = {json.dumps([{k: h[k] for k in ("dH", "accepted", "iterations", "beta_eff",
                                                   "measured")}
                                for h in g["history"]] if key == "history" else g.get(key),
                               sort_keys=True) for g in got}
            if len(vals) != 1:
                fail(f"{what}: the ranks' {key} differ: {vals}")
        for g in got:
            outside = {k: g["launches"][k] for k in HALO_KERNELS if g["launches"][k]}
            if outside:
                fail(f"{what}: kernels launched outside their halo mode on the grid: {outside}")
            for k in halo:
                if g["launches"][f"{k}_halo"] == 0:
                    fail(f"{what}: the halo mode of {k} never launched")
            for rec in g["history"]:
                if rec["worst"] > 1.0 or (rec["iterations"] and max(rec["iterations"]) >= 3000):
                    fail(f"{what}: a solve ended above its target or at its limit")
        for k in HALO_KERNELS + R_KERNELS:
            total = sum(g["launches"][f"{k}_halo"] for g in got)
            if total:
                STATE["launches"].setdefault(k, {})[f"grid {what}, {label} (halo)"] = total
        # the same run on one card, in this process
        one, host, u_one = _grid_step(torch, tag, torch.device("cuda:0"), tmp=tmp)
        _grid_extra(torch, tag, u_one, one)
        grid_u = np.load(os.path.join(tmp, f"{tag}_u.npy"))
        dmax = float(np.max(np.abs(grid_u - host)))
        g0, h_grid, h_one = got[0], got[0]["history"][0], one["history"][0]
        if g0["parts"]:
            diffs = {k: g0["parts"][0][k] - one["parts"][0][k] for k in one["parts"][0]}
            print(f"  ({label}) {what}: the action parts on one card {one['parts'][0]}, the "
                  f"grid's minus one card's {diffs}", flush=True)
        if h_grid["accepted"] != h_one["accepted"]:
            fail(f"{what}: the grid's decision {h_grid['accepted']} is not one card's")
        if tag not in GRID_EXACT:
            if not h_grid["accepted"] and tag != "slhmc":
                fail(f"{what}: a trajectory was rejected, so the links compared are the start's")
            check(f"({label}) {what} complex128 trajectory |ddH| against one process",
                  abs(h_grid["dH"] - h_one["dH"]), 1e-8)
            check(f"({label}) {what} complex128 trajectory max|dU| against one process", dmax,
                  1e-10)
        else:
            if h_grid["dH"] is not None:
                check(f"({label}) {what} |ddH| against one process",
                      abs(h_grid["dH"] - h_one["dH"]), 1e-8)
            check(f"({label}) {what} links against one process", dmax, 1e-12)
            if g0["generator"] != one["generator"]:
                fail(f"{what}: the ranks' generator state is not one process's")
            STATE["checks"] += 1
        for key in ("beta_eff", "measured"):
            a, b = np.asarray(_numbers_of(h_grid[key])), np.asarray(_numbers_of(h_one[key]))
            if a.shape != b.shape:
                fail(f"{what}: the grid's {key} {h_grid[key]} against one card's {h_one[key]}")
            if a.size:
                check(f"({label}) {what} {key} against one process (relative)", _rel(a, b),
                      BARS[dtype_name])
        cg = sum(h_grid["iterations"])
        lattice = "x".join(map(str, _grid_params(tag, tmp).L))
        line = (f"  ({label}) {what}, {lattice} {dtype_name}: {h_grid['seconds']:.3f} s per step on "
                f"the grid against {h_one['seconds']:.3f} s on one card "
                f"({h_grid['seconds'] / h_one['seconds']:.2f}x)")
        if h_grid["dH"] is not None:
            line += (f"; dH {h_grid['dH']!r} (one card {h_one['dH']!r}); solver iterations {cg} "
                     f"({sum(h_one['iterations'])}) in {len(h_grid['iterations'])} solves")
        if tag in ("slhmc", "slmc"):
            line += f"; accepted {h_grid['accepted']}; beta_eff {h_grid['beta_eff']}"
        if tag == "fileloading":
            line += (f"; {len(g0['history'])} configurations, links bitwise {dmax == 0.0}, "
                     f"measured {[h['measured'] for h in g0['history']]}")
        if tag == "heatbath":
            line += (f"; links bitwise {dmax == 0.0}; generator state one card's; one sweep "
                     f"{g0['sweep_seconds']:.3f} s ({one['sweep_seconds']:.3f} s), one "
                     f"overrelaxation {g0['overrelax_seconds']:.3f} s "
                     f"({one['overrelax_seconds']:.3f} s)")
        print(line + f"; launches {g0['launches']} [{STATE['smi']}]", flush=True)
        if tag == "domainwall":
            for g in got:
                per_op = g["per_op"]
                if per_op["wilson_hop_packed_halo"] != 4 * GRID3_DW_L5 or any(
                        per_op[k] for k in HALO_KERNELS):
                    fail(f"one Shat^dag Shat on the grid launched {per_op}, not 4 L5 = "
                         f"{4 * GRID3_DW_L5} halo hops and nothing else")
            STATE["checks"] += 1
            for k in HALO_KERNELS:
                if any(g["measure_launches"][k] for g in got):
                    fail(f"the grid's domain-wall measurements launched {k} outside its halo mode")
            for name, vals in g0["measured"].items():
                check(f"({label}) domain-wall {name} against one process (relative)",
                      _rel(np.asarray(vals), np.asarray(one["measured"][name])), 1e-9)
            cpi, lam = g0["measured"]["Pion_correlator"], g0["measured"]["Dirac_spectrum"]
            if not (min(cpi) > 0 and min(lam) > 0 and lam == sorted(lam)):
                fail(f"the domain-wall measurements are not positive and ordered: {g0['measured']}")
            for k in ("wilson_hop_packed", "wilson_window"):
                total = sum(g["measure_launches"][f"{k}_halo"] for g in got)
                if total == 0:
                    fail(f"the grid's domain-wall measurements never launched {k}'s halo mode")
                STATE["launches"].setdefault(k, {})[
                    f"grid domain-wall measurements, {label} (halo)"] = total
            print(f"  ({label}) one Shat^dag Shat: {g0['per_op']['wilson_hop_packed_halo']} halo "
                  f"hops per rank (4 L5); measurements on the final links, the same bit for bit on "
                  f"every rank: pbp {g0['measured']['Chiral_condensate'][0]!r}, C(0..3) "
                  f"{cpi[:4]}, Ritz values {lam}; seconds "
                  f"{ {k: round(v, 3) for k, v in g0['measure_seconds'].items()} } (one card "
                  f"{ {k: round(v, 3) for k, v in one['measure_seconds'].items()} }); launches "
                  f"{g0['measure_launches']} [{STATE['smi']}]", flush=True)


def phase_grid_more(torch):
    print("== 33. the process grid: Hasenbusch, domain wall and the heatbath, 2 ranks on the "
          "card", flush=True)
    t0 = time.time()
    _grid_group_runs(torch, "gloo", GRID3_RUNS)
    print(f"  (b, c) 2 ranks, gloo, one card (the shared group's runs): {time.time() - t0:.1f} s",
          flush=True)
    if torch.cuda.device_count() >= 2:
        t0 = time.time()
        _grid_group_runs(torch, "nccl", GRID3_RUNS)
        print(f"  (d) 2 ranks, nccl, 2 cards: {time.time() - t0:.1f} s", flush=True)
    else:
        print(f"  (d) nccl: not run, this machine has {torch.cuda.device_count()} card",
              flush=True)


def _numbers_of(value):
    """A history record's beta_eff or measured numbers as one flat list of floats."""
    if value is None:
        return []
    if isinstance(value, dict):
        return [x for k in sorted(value) for x in _numbers_of(value[k])]
    if isinstance(value, (list, tuple)):
        return [x for v in value for x in _numbers_of(v)]
    return [float(value)]


def _grid_confs(torch, tmp):
    """Phase 34's two stored configurations, saved as NPZ under tmp: a 16^3x32 hot start
    and its complex conjugate (SU(3) too, and a hot start's cost saved)."""
    from latticeqcd_torch.io import save_u
    from latticeqcd_torch.ops import fields

    os.makedirs(os.path.join(tmp, GRID4_CONFS))
    u = fields.hot_start(MAIN, 3, seed=41, dtype=torch.complex128, device="cpu").numpy()
    for i, conf in ((1, u), (2, u.conj())):
        save_u(os.path.join(tmp, GRID4_CONFS, f"conf_{i:08d}.npz"), conf)


def phase_grid_selflearning(torch):
    print("== 34. the process grid: stout, the self-learning updaters and Fileloading, 2 ranks "
          "on the card", flush=True)
    t0 = time.time()
    _grid_group_runs(torch, "gloo", GRID4_RUNS)
    print(f"  (a) 2 ranks, gloo, one card (the shared group's runs): {time.time() - t0:.1f} s",
          flush=True)
    if torch.cuda.device_count() >= 2:
        t0 = time.time()
        _grid_group_runs(torch, "nccl", GRID4_RUNS)
        print(f"  (b) 2 ranks, nccl, 2 cards: {time.time() - t0:.1f} s", flush=True)
    else:
        print(f"  (b) nccl: not run, this machine has {torch.cuda.device_count()} card",
              flush=True)


# ------------------------------------------- 35. batched chains on the process grid

GRID_CHAINS = 4  # the chain axis of phase 35 (a) and (c)
CHAIN_HALO_TIMED = (1, 4, 16)
# the chain-halo modes' rows of the kernels line: (kernel, the timing row's label)
CHAIN_HALO_ROWS = {"wilson_hop_packed_chain_halo": "chain-halo hop 4 chains",
                   "staggered_w_chain_halo": "chain-halo staggered hop 4 chains",
                   "wilson_window_chain_halo": "chain-halo window D 4 chains"}


def _chain_halo_counts():
    """The chain-halo modes' launches (also counted in each kernel's halo_launches)."""
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    return {"wilson_hop_packed_chain_halo": wk.chain_halo_launches,
            "staggered_w_chain_halo": sk.chain_halo_launches,
            "wilson_window_chain_halo": ww.chain_halo_launches}


def _stacked_faces(torch, grid, fields, links):
    """_block_faces of each chain (fields[c], links[c]) stacked chain after chain, as the
    exchange of a field with a chain axis delivers them, and each chain's own."""
    per = [_block_faces(grid, f, u) for f, u in zip(fields, links)]
    faces = {mu: tuple(torch.stack([p[0][mu][k] for p in per]) for k in (0, 1))
             for mu in per[0][0]}
    return faces, {mu: torch.stack([p[1][mu] for p in per]) for mu in per[0][1]}, per


@functools.lru_cache(maxsize=None)
def _hot_start(lat, seed):
    """A hot start on the card, made once per lattice and seed (the host draws it)."""
    from latticeqcd_torch.ops import fields as tf

    return tf.hot_start(lat, 3, seed=seed, device="cuda")


def _chain_halo_case(torch, kind, dtype, lat, n, seed):
    """The global fields (u_e, u_o, x) of the chain-halo mode ``kind`` ("hop", "staggered" or
    "window", whose links are u_e = u_o, full) for n chains: the links of chain c the hot start
    shifted c sites along t times exp(0.1 i c) (_chain_links), the fields Gaussian."""
    u = _hot_start(lat, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "window":
        uu = _window_chain_links(torch, u, dtype, n)
        x = torch.randn((n,) + lat + (4, 3), dtype=dtype, device="cuda", generator=g)
        return uu, uu, x
    u_e, u_o = _chain_links(torch, u, dtype, n)
    site = (3,) if kind == "staggered" else (4, 3)
    x = torch.randn((n, lat[0] // 2) + lat[1:] + site, dtype=dtype, device="cuda", generator=g)
    return u_e, u_o, x


def _chain_halo_checks(torch):
    """(a): the three chain-halo modes on every block of 16^3x32 cut in two along each axis in
    turn, GRID_CHAINS chains: each chain against the plain halo version and bit for bit
    against the one-chain halo launch on it, one launch per call; the packed hop's backward
    against the global autograd's block."""
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.parallel import mesh

    n, lat = GRID_CHAINS, MAIN
    bitwise = {}
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        bar = BARS[name]
        for kind, kernel in (("hop", "wilson_hop_packed"), ("staggered", "staggered_w"),
                             ("window", "wilson_window")):
            u_e, u_o, x = _chain_halo_case(torch, kind, dtype, lat, n, seed=351)
            if kind == "window":
                runs = [(0, u_e, u_o, x, None)]
            else:
                runs = [(0, u_e, u_o, x, None), (1, u_o, u_e, x, None)]
            if kind == "staggered":  # the grid W's axpy launch on the faces of d1
                d1 = sk.staggered_hop_packed(u_o, u_e, x, 1)
                runs.append((0, u_e, u_o, d1, x))
            if kind == "hop":
                cot = torch.randn(x.shape, dtype=dtype, device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(352))
            same = True
            for parity, u_t, u_s, src, phi in runs:
                def call(blocks, faces, links, phi_b=None):
                    if kind == "hop":
                        return wk.hop_packed_halo(*blocks, parity, faces, links)
                    if kind == "staggered":
                        return sk.hop_packed_halo(*blocks, parity, faces, links, phi=phi_b,
                                                  mass=MASS)
                    return ww.dslash_halo(blocks[0], blocks[2], KAPPA, faces, links)

                def plain(blocks, faces, links, phi_b=None):
                    if kind == "hop":
                        return wk.hop_packed_halo_reference(*blocks, parity, faces, links)
                    if kind == "staggered":
                        out = sk.hop_packed_halo_reference(*blocks, parity, faces, links)
                        return out if phi_b is None else MASS ** 2 * phi_b - out
                    return wk.dslash_halo_reference(blocks[0], blocks[2], KAPPA, faces, links)

                if kind == "hop":
                    leaves = [t.detach().clone().requires_grad_(True) for t in (u_t, u_s, src)]
                    grads = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity), leaves, cot)
                    _, moving, _ = wk.halo_link_grads(cot, src, parity, {})
                    g5 = wk.gamma5(cot)
                for mu in range(4):
                    pes = tuple(2 if d == mu else 1 for d in range(4))
                    for rank in (0, 1):
                        grid = mesh.ProcessGrid(pes, lat, rank=rank, device="cuda")
                        tag = f"{kind} cut {'xyzt'[mu]} block {rank} p={parity} {name}"
                        if phi is not None:
                            tag += " W axpy"
                        blocks = [grid.block(t, 2).contiguous() for t in (u_t, u_s)] + [
                            grid.block(src, 1).contiguous()]
                        phi_b = None if phi is None else grid.block(phi, 1).contiguous()
                        faces, links, per = _stacked_faces(torch, grid, src, u_s)
                        before = _chain_halo_counts()[f"{kernel}_chain_halo"]
                        got = call(blocks, faces, links, phi_b)
                        torch.cuda.synchronize()
                        if _chain_halo_counts()[f"{kernel}_chain_halo"] != before + 1:
                            fail(f"the chain-halo mode of {kernel} did not launch once")
                        check(f"chain-halo {tag} vs plain", maxdiff(got, plain(
                            blocks, faces, links, phi_b)), bar, f"{kernel}_chain_halo")
                        for c in range(n):
                            one = call([b[c] for b in blocks], *per[c],
                                       None if phi_b is None else phi_b[c])
                            same &= bool(torch.equal(got[c], one))
                        if kind == "hop":
                            gfaces, tlinks, _ = _stacked_faces(torch, grid, g5, u_t)
                            d_psi = wk.gamma5(wk.hop_packed_halo(
                                blocks[1], blocks[0], grid.block(g5, 1).contiguous(), 1 - parity,
                                gfaces, tlinks))
                            check(f"chain-halo backward d psi {tag}",
                                  maxdiff(d_psi, grid.block(grads[2], 1)), bar, f"{kernel}_chain_halo")
                            d_ut, moving_b, staying = wk.halo_link_grads(
                                grid.block(cot, 1), blocks[2], parity, faces)
                            m = src.shape[1 + mu] // 2
                            heads = {mu: _face_slab(grid, moving[mu], mu,
                                                    ((rank + 1) * m) % src.shape[1 + mu], lead=1)}
                            d_us = wk.scatter_halo(moving_b, staying, heads, lead=1)
                            check(f"chain-halo backward d u_t {tag}",
                                  maxdiff(d_ut, grid.block(grads[0], 2)), bar, f"{kernel}_chain_halo")
                            check(f"chain-halo backward d u_s {tag}",
                                  maxdiff(d_us, grid.block(grads[1], 2)), bar, f"{kernel}_chain_halo")
            bitwise[(kind, name)] = same
            if not same:
                fail(f"a chain of {kernel}'s chain-halo mode ({name}) is not bit for bit the "
                     "one-chain halo mode's")
            STATE["checks"] += 1
    print(f"  chain-halo modes: every chain bit for bit the one-chain halo launch's: {bitwise}",
          flush=True)


def _chain_halo_timing(torch):
    """(a): the chain-halo modes timed on the t cut's 16^3x16 block (CUDA graphs between CUDA
    events, cold: three input sets in turn), n = 1, 4 and 16 chains in one launch against n
    one-chain halo launches, beside the bound: n times the one-chain halo mode's least bytes
    (the block's links, source and target fields once, and the two spinor faces and the
    link face of the cut axis) over the HBM rate."""
    from latticeqcd_torch.ops.dirac import staggered_kernel as sk
    from latticeqcd_torch.ops.dirac import wilson_kernel as wk
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.parallel import mesh

    grid = mesh.ProcessGrid((1, 1, 1, 2), MAIN, rank=0, device="cuda")
    block = grid.local
    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype).split(".")[1]
        f = 2 if dtype == torch.complex128 else 1
        for kind, kernel, label in (("hop", "wilson_hop_packed", "chain-halo hop"),
                                    ("staggered", "staggered_w", "chain-halo staggered hop"),
                                    ("window", "wilson_window", "chain-halo window D")):
            packed = kind != "window"
            sites = math.prod(block) // (2 if packed else 1)
            face_sites = sites // block[3]
            spinor = 24 if kind == "staggered" else 96
            links = 576 if packed else 288
            one_bytes = f * (sites * (links + 2 * spinor) + face_sites * (2 * spinor + 72))
            flop_site = {"hop": 1320, "staggered": 570, "window": 1320}[kind]
            line = []
            for n in CHAIN_HALO_TIMED:
                sets = []
                for seed in (361, 362, 363):
                    u_e, u_o, x = _chain_halo_case(torch, kind, dtype, MAIN, n, seed)
                    blocks = [grid.block(t, 2).contiguous() for t in (u_e, u_o)] + [
                        grid.block(x, 1).contiguous()]
                    faces, links_, per = _stacked_faces(torch, grid, x, u_o)
                    sets.append((blocks, faces, links_, per))
                    del u_e, u_o, x

                def call(b, fc, lk):
                    if kind == "hop":
                        return wk.hop_packed_halo(*b, 0, fc, lk)
                    if kind == "staggered":
                        return sk.hop_packed_halo(*b, 0, fc, lk)
                    return ww.dslash_halo(b[0], b[2], KAPPA, fc, lk)

                together = [lambda s=s: call(*s[:3]) for s in sets]
                apart = [lambda s=s: [call([b[c] for b in s[0]], *s[3][c]) for c in range(n)]
                         for s in sets]
                t_apart = _time_device(torch, apart)
                t_one = _time_device(torch, together)
                nbytes = n * one_bytes
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = n * sites * flop_site / PEAK_FLOP_PER_S[name] * 1e3
                bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
                if n == GRID_CHAINS:
                    plain = [lambda s=sets[0]: (wk.hop_packed_halo_reference(*s[0], 0, s[1], s[2])
                                                if kind == "hop" else
                                                sk.hop_packed_halo_reference(*s[0], 0, s[1], s[2])
                                                if kind == "staggered" else
                                                wk.dslash_halo_reference(s[0][0], s[0][2], KAPPA,
                                                                         s[1], s[2]))]
                    STATE["timing"][(f"{label} {n} chains", name)] = {
                        "ms": t_one, "plain_ms": _time_device(torch, plain, reps=4, n=5),
                        "bound_ms": bound, "bound_by": by}
                line.append(f"{n} chains: one launch {t_one * 1e3:.1f} us, {n} one-chain halo "
                            f"launches {t_apart * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                            f"({by}; {100 * bound / t_one:.1f}% of it in one launch)")
                del sets, together, apart
            print(f"  {label} {name} on the 16^3x16 block of a t cut, cold: " + "; ".join(line)
                  + f"  [{STATE['smi']}]", flush=True)


# (b) the chain split: bench.py tier2's action at 4^4 as 64 complex64 chains (phase 29's)
TIER2_CHAINS, TIER2_LAT = 64, (4, 4, 4, 4)
# (c) the lattice grid at full width: phase 6's Wilson action, GRID_CHAINS complex64 chains
GRID5_MD = 2
# (d) the same grid at 8^4, 2 complex128 chains of 2 MD steps of 0.005, against one process
GRID5_LAT, GRID5_NCHAIN = (8, 8, 8, 8), 2
GRID5_FAMILY = ("wilson", "wilson_r", "clover_hasenbusch", "domainwall", "stout", "staggered",
                "mixed")


class _Messages:
    """torch.distributed's point-to-point messages and collectives, counted while active."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.counts, self.sizes = dist, {}, []
        self.real = {k: getattr(dist, k) for k in ("batch_isend_irecv", "all_reduce",
                                                   "all_gather", "gather", "broadcast")}

    def __enter__(self):
        def wrap(name, real):
            def counted(*a, **k):
                self.counts[name] = self.counts.get(name, 0) + 1
                if name == "batch_isend_irecv":
                    self.sizes.extend(op.tensor.numel() for op in a[0])
                return real(*a, **k)
            return counted

        for name, real in self.real.items():
            setattr(self.dist, name, wrap(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.dist, name, real)


def _tier2_hmc():
    """bench.py tier2's action: beta 6.0, kappa 0.141139, dtau 0.1, 10 MD steps (phase 29)."""
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    return HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.1, md_steps=10,
               fermi_action=WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-12, max_cg=3000))


def _grid5_hmc(tag, lattice):
    """An HMC of phase 35 (d) (``lattice``: what the staggered operator acts on), or (c)'s
    Wilson action ("main")."""
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
    from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import (DomainwallFermiAction,
                                                     HasenbuschWilsonFermiAction,
                                                     StaggeredFermiAction, WilsonFermiAction)
    from latticeqcd_torch.smearing.stout import stout_stack
    from latticeqcd_torch.updates.hmc import HMC

    if tag == "main":
        return HMC(action=ga.wilson_gauge_action(3, 6.0), dtau=0.02, md_steps=GRID5_MD,
                   fermi_action=WilsonFermiAction(WilsonDirac(kappa=KAPPA), eps_cg=1e-12,
                                                  max_cg=3000))
    eps = dict(eps_cg=1e-20, max_cg=3000)
    kw, beta = {}, 6.0
    if tag in ("wilson", "stout", "mixed", "wilson_r"):
        fa = WilsonFermiAction(WilsonDirac(kappa=KAPPA, r=R_MODE if tag == "wilson_r" else 1.0),
                               **eps)
        if tag == "stout":
            kw["smearing"] = stout_stack((0.1,))
        if tag == "mixed":
            kw["md_precision"] = "mixed"
    elif tag == "clover_hasenbusch":
        fa = HasenbuschWilsonFermiAction(WilsonDirac(kappa=CLOVER_KAPPA, csw=CLOVER_CSW), mu=0.5,
                                         **eps)
        kw.update(sexton_weingarten=True, nsw=2)
        beta = CLOVER_BETA
    elif tag == "domainwall":
        fa = DomainwallFermiAction(DomainwallDirac(DW_MASS, DW_M5, 4), **eps)
    else:
        fa = StaggeredFermiAction(StaggeredDirac(MASS, tuple(lattice)), nf=4, **eps)
        beta = 5.7
    return HMC(action=ga.wilson_gauge_action(3, beta), dtau=0.005, md_steps=2, fermi_action=fa,
               **kw)


def _tier2_feeds(torch, device):
    """(b)'s TIER2_CHAINS hot starts and the feeds of its two trajectories: the first from
    each chain's draws with the Metropolis uniform 0 (every chain accepted, so that evolved
    links are compared), the second from the chains' generators, which drew the first."""
    from latticeqcd_torch.updates.hmc import Draws

    us, gens = _grid5_chains(torch, TIER2_LAT, TIER2_CHAINS, 400, torch.complex64, device)
    draws = [Draws(d.mom, d.xi, 0.0) for d in (Draws.sample(_tier2_hmc(), us[i], gens[i])
                                              for i in range(TIER2_CHAINS))]
    return us, [{"draws": draws}, {"generators": gens}]


def _grid5_chains(torch, lat, n, seed, dtype, device):
    """n hot starts of ``lat`` (this rank's blocks under a grid) and their generators."""
    from latticeqcd_torch.ops import fields

    us = torch.stack([fields.hot_start(lat, 3, seed=seed + i, dtype=dtype, device=device)
                      for i in range(n)])
    return us, [torch.Generator(device=device).manual_seed(seed + 100 + i) for i in range(n)]


def _grid5_rank(torch, device, tmp, rank, nprocs):
    """Phase 35's runs on a rank of the shared group (its grid (1, 1, 1, 2)): (b) the tier2
    chains split over the ranks, (c) GRID_CHAINS Wilson chains on 16^3x32 cut along t, (d)
    the Wilson family and staggered at 8^4 cut along t; the report (dH, decisions,
    seconds, launches, messages) returned, each run's links saved under tmp."""
    import numpy as np

    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac, apply_boundary_phases
    from latticeqcd_torch.parallel import mesh

    rep = {}
    c64, c128 = torch.complex64, torch.complex128
    # (b) the chain split: each rank its share of the 64 chains, from the generators of all 64
    split = mesh.make_process_grid((1, 1, 1, 1), TIER2_LAT, device, chain_groups=nprocs)
    with mesh.use_grid(split):
        share = mesh.chain_share(list(range(TIER2_CHAINS)))
        us, feeds = _tier2_feeds(torch, device)
        us = us[share[0]:share[-1] + 1].contiguous()
        hmc, traj = _tier2_hmc(), []
        for k, feed in enumerate(feeds):
            torch.cuda.synchronize(device)
            t0 = time.time()
            with _Messages() as msgs:
                us, st = hmc.step_batched(us, **feed)
            torch.cuda.synchronize(device)
            traj.append({"seconds": time.time() - t0, "dH": st["dH"].tolist(),
                         "accepted": st["accepted"].tolist(), "messages": msgs.counts})
        np.save(os.path.join(tmp, f"split_u_rank{rank}.npy"), us.cpu().numpy())
        rep["split"] = {"chains": share, "trajectories": traj}
    # (c) the lattice grid at full width, GRID_CHAINS chains
    grid = mesh.make_process_grid((1, 1, 1, 2), MAIN, device)
    with mesh.use_grid(grid):
        us, gens = _grid5_chains(torch, MAIN, GRID_CHAINS, 800, c64, device)
        hmc = _grid5_hmc("main", MAIN)
        _zero_all_counts()
        torch.cuda.synchronize(device)
        t0 = time.time()
        us, st = hmc.step_batched(us, gens)
        torch.cuda.synchronize(device)
        rec = {"seconds": time.time() - t0, "dH": st["dH"].tolist(),
               "accepted": st["accepted"].tolist(), "launches": _all_counts(),
               "chain_halo": _chain_halo_counts(),
               "cg": [{"rsq": c["rsq"], "target": c["target"], "iterations": c["iterations"]}
                      for c in st["cg"]]}
        # one batched hop on the final links, their faces exchanged by a first one
        d = WilsonDirac(kappa=KAPPA)
        ueo = d.packed_links(apply_boundary_phases(us))
        x = torch.ones((GRID_CHAINS, grid.local[0] // 2) + grid.local[1:] + (4, 3), dtype=c64,
                       device=device)
        d.hop_packed(*ueo, x, 0)
        before = _chain_halo_counts()["wilson_hop_packed_chain_halo"]
        with _Messages() as msgs:
            d.hop_packed(*ueo, x, 0)
        torch.cuda.synchronize(device)
        rec["hop"] = {"launches": _chain_halo_counts()["wilson_hop_packed_chain_halo"] - before,
                      "messages": msgs.counts, "sizes": sorted(msgs.sizes)}
        rep["main"] = rec
    # (d) the family at 8^4, against one process in the parent
    grid = mesh.make_process_grid((1, 1, 1, 2), GRID5_LAT, device)
    with mesh.use_grid(grid):
        for i, tag in enumerate(GRID5_FAMILY):
            us, gens = _grid5_chains(torch, GRID5_LAT, GRID5_NCHAIN, 1000 + 10 * i, c128, device)
            _zero_all_counts()
            torch.cuda.synchronize(device)
            t0 = time.time()
            us, st = _grid5_hmc(tag, grid.local).step_batched(us, gens)
            torch.cuda.synchronize(device)
            host = mesh.to_host_global(us, lead=2)
            if host is not None:
                np.save(os.path.join(tmp, f"family_{tag}_u.npy"), host)
            rep[tag] = {"seconds": time.time() - t0, "dH": st["dH"].tolist(),
                        "accepted": st["accepted"].tolist(), "launches": _all_counts(),
                        "chain_halo": _chain_halo_counts()}
    return rep


def _grid5_split(torch, reps, tmp):
    """(b): the ranks' shares of the tier2 chains against one process's step_batched over all
    64 from the same generators; no message and no collective in the ranks' steps."""
    import numpy as np

    us, feeds = _tier2_feeds(torch, torch.device("cuda"))
    hmc, ref = _tier2_hmc(), []
    for feed in feeds:
        torch.cuda.synchronize()
        t0 = time.time()
        us, st = hmc.step_batched(us, **feed)
        torch.cuda.synchronize()
        ref.append((time.time() - t0, st["dH"].numpy(), st["accepted"].numpy()))
    u_ref = us.cpu().numpy()
    bitwise, ddh, du = True, 0.0, 0.0
    for r, rep in enumerate(reps):
        got = rep["batched"]["split"]
        sl = slice(got["chains"][0], got["chains"][-1] + 1)
        for k, tr in enumerate(got["trajectories"]):
            if tr["messages"]:
                fail(f"the chain split's rank {r} communicated in its step: {tr['messages']}")
            dh = np.asarray(tr["dH"])
            ddh = max(ddh, float(np.abs(dh - ref[k][1][sl]).max()))
            bitwise &= bool(np.array_equal(dh, ref[k][1][sl]))
            if tr["accepted"] != ref[k][2][sl].tolist():
                fail(f"the chain split's decisions on rank {r} are not one process's")
        u = np.load(os.path.join(tmp, f"split_u_rank{r}.npy"))
        du = max(du, float(np.abs(u - u_ref[sl]).max()))
        bitwise &= bool(np.array_equal(u, u_ref[sl]))
    STATE["checks"] += 1
    check("(b) the chain split's dH against one process's step_batched (complex64)", ddh, 5e-4)
    check("(b) the chain split's links against one process's step_batched (complex64)", du, 1e-5)
    t_split = max(rep["batched"]["split"]["trajectories"][1]["seconds"] for rep in reps)
    cps = STATE.get("batched_cps", {}).get("tier2 4^4 Wilson c64")
    print(f"  (b) {TIER2_CHAINS} tier2 chains split over {len(reps)} gloo ranks on one card, "
          f"{TIER2_CHAINS // len(reps)} each: bit for bit one process's step_batched: {bitwise}; "
          f"no message and no collective in either rank's steps; second trajectory "
          f"{t_split:.3f} s on the slower rank, {TIER2_CHAINS / t_split:.2f} configurations/s "
          f"(one process of {TIER2_CHAINS} chains here {ref[1][0]:.3f} s, "
          f"{TIER2_CHAINS / ref[1][0]:.2f}; phase 29's {cps if cps is None else round(cps, 2)})"
          f"  [{STATE['smi']}]", flush=True)


def _grid5_main(torch, reps):
    """(c): GRID_CHAINS complex64 Wilson chains on 16^3x32 cut along t."""
    recs = [rep["batched"]["main"] for rep in reps]
    if len({json.dumps(r["dH"]) for r in recs}) != 1 or any(
            r["accepted"] != recs[0]["accepted"] for r in recs):
        fail(f"(c) the ranks' dH or decisions differ: {[r['dH'] for r in recs]}")
    if not all(math.isfinite(x) for x in recs[0]["dH"]):
        fail(f"(c) a non-finite dH: {recs[0]['dH']}")
    local_face = GRID_CHAINS * (MAIN[0] // 2) * MAIN[1] * MAIN[2] * 12
    for r, rec in enumerate(recs):
        if any(c["rsq"] > c["target"] for c in rec["cg"]):
            fail(f"(c) a verified solve on rank {r} ended above its target")
        outside = {k: rec["launches"][k] for k in HALO_KERNELS if rec["launches"][k]}
        if outside or rec["chain_halo"]["wilson_hop_packed_chain_halo"] == 0 or \
                rec["chain_halo"]["wilson_hop_packed_chain_halo"] != rec["launches"][
                    "wilson_hop_packed_halo"]:
            fail(f"(c) rank {r} launched {rec['launches']}, chain-halo {rec['chain_halo']}")
        hop = rec["hop"]
        if hop["launches"] != 1 or hop["messages"] != {"batch_isend_irecv": 1} or \
                hop["sizes"] != [local_face] * 4:
            fail(f"(c) a batched hop on rank {r} made {hop}, not one chain-halo launch and one "
                 f"chain's 4 messages (2 sends, 2 receives) of {local_face} elements")
    STATE["checks"] += 1
    total = sum(r["chain_halo"]["wilson_hop_packed_chain_halo"] for r in recs)
    STATE["launches"].setdefault("wilson_hop_packed_chain_halo", {})[
        f"grid batched Wilson 16^3x32 x{GRID_CHAINS}, gloo, 2 ranks"] = total
    its = [c["iterations"] for c in recs[0]["cg"]]
    print(f"  (c) {GRID_CHAINS} complex64 Wilson chains at 16^3x32 on the grid (1, 1, 1, 2), gloo, "
          f"one card: {recs[0]['seconds']:.3f} s per trajectory of {GRID5_MD} MD steps "
          f"({GRID_CHAINS / recs[0]['seconds']:.3f} configurations/s); dH {recs[0]['dH']} bit for "
          f"bit on both ranks; CG iterations {its}; chain-halo hops {total} over both ranks; a "
          f"hop: 1 launch, messages {recs[0]['hop']['sizes']} elements  [{STATE['smi']}]",
          flush=True)


def _grid5_family(torch, reps, tmp):
    """(d): each run of the family on the grid against one process's step_batched of the
    same chains on the whole 8^4 lattice (dH 1e-8, links 1e-10)."""
    import numpy as np

    dev = torch.device("cuda")
    want_kernel = {"staggered": "staggered_w_chain_halo",
                   "clover_hasenbusch": "wilson_window_chain_halo"}
    for i, tag in enumerate(GRID5_FAMILY):
        recs = [rep["batched"][tag] for rep in reps]
        if len({json.dumps(r["dH"]) for r in recs}) != 1:
            fail(f"(d) {tag}: the ranks' dH differ")
        kernel = want_kernel.get(tag, "wilson_hop_packed_chain_halo")
        for r, rec in enumerate(recs):
            outside = {k: rec["launches"][k] for k in HALO_KERNELS if rec["launches"][k]}
            if outside or rec["chain_halo"][kernel] == 0:
                fail(f"(d) {tag} on rank {r} launched {rec['launches']}, chain-halo "
                     f"{rec['chain_halo']}")
        for k in CHAIN_HALO_ROWS:
            total = sum(r["chain_halo"][k] for r in recs)
            if total:
                STATE["launches"].setdefault(k, {})[f"grid batched {tag} 8^4 x2, gloo"] = total
        us, gens = _grid5_chains(torch, GRID5_LAT, GRID5_NCHAIN, 1000 + 10 * i, torch.complex128,
                                 dev)
        torch.cuda.synchronize()
        t0 = time.time()
        u1, st = _grid5_hmc(tag, GRID5_LAT).step_batched(us, gens)
        torch.cuda.synchronize()
        t_one = time.time() - t0
        if st["accepted"].tolist() != recs[0]["accepted"]:
            fail(f"(d) {tag}: the grid's decisions {recs[0]['accepted']} are not one process's")
        if not st["accepted"].all():
            fail(f"(d) {tag}: a rejected chain leaves the start's links to compare")
        check(f"(d) {tag} 8^4 complex128 x{GRID5_NCHAIN}: |ddH| on the grid against one process",
              float(np.abs(np.asarray(recs[0]["dH"]) - st["dH"].numpy()).max()), 1e-8)
        u_grid = np.load(os.path.join(tmp, f"family_{tag}_u.npy"))
        check(f"(d) {tag}: max|dU| on the grid against one process",
              float(np.abs(u_grid - u1.cpu().numpy()).max()), 1e-10)
        print(f"  (d) {tag}: {recs[0]['seconds']:.3f} s per batched trajectory on the grid against "
              f"{t_one:.3f} s on one card; dH {recs[0]['dH']}; chain-halo launches per rank "
              f"{recs[0]['chain_halo']}  [{STATE['smi']}]", flush=True)


def _grid5_both_rank(argv):
    """A rank of (e): 2 chain groups of the grid (1, 1, 1, 2) over 8^4 on nccl, each running
    its 2 of 4 complex128 Wilson chains; writes <tmp>/both_rank<r>.json and, on each group's
    first rank, the group's gathered links."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from latticeqcd_torch.parallel import mesh

    rank, port, tmp = int(argv[0]), argv[1], argv[2]
    mesh.init_process_grid("nccl", f"127.0.0.1:{port}", 4, rank, timeout_s=600)
    device = torch.device(f"cuda:{rank}")
    try:
        grid = mesh.make_process_grid((1, 1, 1, 2), GRID5_LAT, device, chain_groups=2)
        with mesh.use_grid(grid):
            us, gens = _grid5_chains(torch, GRID5_LAT, 4, 1000, torch.complex128, device)
            share = mesh.chain_share(list(range(4)))
            with _Messages() as msgs:
                u, st = _grid5_hmc("wilson", grid.local).step_batched(
                    us[share[0]:share[-1] + 1].contiguous(), gens)
            host = mesh.to_host_global(u, lead=2)
            if host is not None:
                np.save(os.path.join(tmp, f"both_u_group{grid.chains.index}.npy"), host)
            rec = {"chains": share, "dH": st["dH"].tolist(), "accepted": st["accepted"].tolist(),
                   "messages": msgs.counts}
    finally:
        mesh.close_process_grid()
    with open(os.path.join(tmp, f"both_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _grid5_both(torch):
    """(e): 4 Wilson chains on 2 chain groups x (1, 1, 1, 2) over 8^4, nccl on 4 cards, against
    one process's step_batched over the 4 (dH 1e-8, links 1e-10)."""
    import shutil
    import socket
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="chip_smoke_both_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke as c; "
                "c._grid5_both_rank(sys.argv[1:])")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), tmp], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(4)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(out[-3000:])
                print(err[-3000:])
                fail(f"(e) rank {r} exited {p.returncode}")
        recs = []
        for r in range(4):
            with open(os.path.join(tmp, f"both_rank{r}.json")) as f:
                recs.append(json.load(f))
        dev = torch.device("cuda")
        us, gens = _grid5_chains(torch, GRID5_LAT, 4, 1000, torch.complex128, dev)
        u1, st = _grid5_hmc("wilson", GRID5_LAT).step_batched(us, gens)
        for g in (0, 1):
            rec, mate = recs[2 * g], recs[2 * g + 1]
            sl = slice(2 * g, 2 * g + 2)
            if rec["dH"] != mate["dH"] or rec["accepted"] != st["accepted"][sl].tolist():
                fail(f"(e) group {g}: the ranks' dH or decisions differ from each other or from "
                     "one process's")
            check(f"(e) group {g} |ddH| against one process",
                  float(np.abs(np.asarray(rec["dH"]) - st["dH"][sl].numpy()).max()), 1e-8)
            u = np.load(os.path.join(tmp, f"both_u_group{g}.npy"))
            check(f"(e) group {g} max|dU| against one process",
                  float(np.abs(u - u1[sl].cpu().numpy()).max()), 1e-10)
        print(f"  (e) 2 chain groups x (1, 1, 1, 2) on nccl: messages per rank "
              f"{[r['messages'] for r in recs]}  [{STATE['smi']}]", flush=True)
    finally:
        shutil.rmtree(tmp, True)


def phase_grid_batched(torch):
    print("== 35. batched chains on the process grid", flush=True)
    t0 = time.time()
    _chain_halo_checks(torch)
    t1 = time.time()
    _chain_halo_timing(torch)
    _hot_start.cache_clear()
    print(f"  (a) the chain-halo modes in one process: {time.time() - t0:.1f} s (checks "
          f"{t1 - t0:.1f} s)", flush=True)
    reps, tmp, _ = _grid_group(torch, "gloo")
    t0 = time.time()
    _grid5_split(torch, reps, tmp)
    _grid5_main(torch, reps)
    _grid5_family(torch, reps, tmp)
    print(f"  (b-d) the shared group's batched runs against one card: {time.time() - t0:.1f} s "
          f"(the group's own time is in phase 31's line)", flush=True)
    if torch.cuda.device_count() >= 4:
        t0 = time.time()
        _grid5_both(torch)
        print(f"  (e) 2 chain groups x (1, 1, 1, 2), nccl, 4 cards: {time.time() - t0:.1f} s",
              flush=True)
    else:
        print(f"  (e) nccl with 2 chain groups: not run, this machine has "
              f"{torch.cuda.device_count()} card", flush=True)


PHASES = [phase_env, phase_build, phase_kernels, phase_timing,
          phase_trajectory_agreement, phase_main_path, phase_staggered_kernels,
          phase_staggered_timing, phase_staggered_trajectory_agreement, phase_staggered_main_path,
          phase_window, phase_window_timing, phase_measurement_agreement, phase_measurement_path,
          phase_disk, phase_anchor, phase_quenched_agreement, phase_quenched_path,
          phase_plaquette_anchor, phase_grid_start, phase_improved_agreement,
          phase_domainwall_agreement, phase_selflearning_agreement, phase_clover_agreement,
          phase_improved_path, phase_domainwall_path, phase_selflearning_path, phase_clover_path,
          phase_batched_agreement, phase_batched_path, phase_frontend, phase_grid,
          phase_grid_fermions, phase_grid_more, phase_grid_selflearning, phase_grid_batched]

KERNELS = [
    # name, source, the TPU kernel it replaces, the timing row of its line
    ("wilson_hop_packed", "latticeqcd_torch/csrc/wilson_hop_packed.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:414", ("packed hop", "complex64")),
    ("staggered_w", "latticeqcd_torch/csrc/staggered_w.cu",
     "latticeqcd_tpu/ops/dirac/staggered_pallas.py:274", ("staggered W", "complex64")),
    ("wilson_window", "latticeqcd_torch/csrc/wilson_window.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:349", ("window D", "complex64")),
    # the r modes (the _r entry points, Wilson r != 1) of the two Wilson kernels
    ("wilson_hop_packed_r", "latticeqcd_torch/csrc/wilson_hop_packed.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:414", (f"packed hop r={R_MODE}", "complex64")),
    ("wilson_window_r", "latticeqcd_torch/csrc/wilson_window.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:349", (f"window D r={R_MODE}", "complex64")),
    # wilson_window's chain axis (the chains entry points), 16 chains at 8^4 in one launch
    ("wilson_window_chains", "latticeqcd_torch/csrc/wilson_window.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:349",
     (f"window D {WINDOW_CHAINS_TIMED[1]} chains {WINDOW_CHAINS_TIMED[0][0]}^4", "complex64")),
    # the chain-halo modes (a chain axis on a block of a process grid), GRID_CHAINS chains on
    # the t cut's 16^3x16 block
    ("wilson_hop_packed_chain_halo", "latticeqcd_torch/csrc/wilson_hop_packed.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:414",
     (CHAIN_HALO_ROWS["wilson_hop_packed_chain_halo"], "complex64")),
    ("staggered_w_chain_halo", "latticeqcd_torch/csrc/staggered_w.cu",
     "latticeqcd_tpu/ops/dirac/staggered_pallas.py:274",
     (CHAIN_HALO_ROWS["staggered_w_chain_halo"], "complex64")),
    ("wilson_window_chain_halo", "latticeqcd_torch/csrc/wilson_window.cu",
     "latticeqcd_tpu/ops/dirac/wilson_pallas.py:349",
     (CHAIN_HALO_ROWS["wilson_window_chain_halo"], "complex64")),
]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import latticeqcd_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the latticeqcd_torch package is not beside this script: {exc}")
    t0 = time.time()
    for phase in PHASES:
        t_phase = time.time()
        phase(torch)
        print(f"  {phase.__name__}: {time.time() - t_phase:.1f} s", flush=True)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "latticeqcd_tpu"))
    if leaked:
        fail(f"the port imported the JAX side: {leaked}")
    kernels = []
    for name, source, replaces, row in KERNELS:
        timing = STATE["timing"][row]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # launches summed over the main paths that run the kernel (printed per path)
            "launches": sum(STATE["launches"][name].values()), "max_abs_err": STATE["err"][name],
            "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            # no single PyTorch call computes a Wilson or a staggered hop
            "library_ms": None,
        })
    print(f"kernels: {', '.join(k[0] for k in KERNELS)} ({STATE['checks']} checks; largest error "
          f"off the paths: the yardstick wilson_hop {STATE['err']['wilson_hop']:.3e}, the one-launch "
          f"staggered W {STATE['err']['staggered_w_fused']:.3e}); "
          f"launches per main path {STATE['launches']}; total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
