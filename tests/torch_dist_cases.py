"""Ranks of the port's distributed tests: the spawn helper and the case
functions each rank runs (imported by tests/test_torch_distributed.py and
tests/test_torch_xshard2d.py; this module imports torch and the port,
never jax, since every spawned rank imports it).

spawn_ranks starts ``world`` processes (the 'spawn' start method), each
with one intra-op thread, joined by a gloo process group with a file://
rendezvous under the caller's directory (or an 'nccl' one on the cards),
and returns a handle whose
result() waits for them up to a deadline, kills every rank still running
when it passes or when one rank fails, and returns rank 0's return value
(the cases gather what they return onto every rank).
"""
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _rank_main(target, rank, world, workdir, args, backend):
    """A spawned rank: its group, target's result pickled to
    workdir/rank<r>.pkl, or its traceback to rank<r>.err and exit 1."""
    torch.set_num_threads(1)
    out = os.path.join(workdir, f'rank{rank}')
    try:
        from lightweaver_tpu_torch.parallel.multihost import \
            initialize_multihost
        initialize_multihost(
            init_method='file://' + os.path.join(workdir, 'rendezvous'),
            num_processes=world, process_id=rank, backend=backend)
        result = target(rank, world, *args)
        dist.barrier()
        with open(out + '.pkl', 'wb') as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


class Ranks:
    """The ranks of one spawn (spawn_ranks)."""

    def __init__(self, target, world, workdir, args, timeout, backend):
        ctx = mp.get_context('spawn')
        self.workdir = str(workdir)
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(target, r, world, self.workdir, args,
                                        backend),
                                  daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._result = None

    def _errors(self):
        errs = []
        for r in range(len(self.procs)):
            path = os.path.join(self.workdir, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f'rank {r}:\n{f.read()}')
        return '\n'.join(errs)

    def result(self):
        """Rank 0's return value, once every rank has exited 0; raises
        (after killing the ranks) on a failure or past the deadline."""
        if self._result is not None:
            return self._result
        try:
            while any(p.is_alive() for p in self.procs):
                if any(p.exitcode not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f'the ranks ran past their '
                                       f'{self.timeout} s deadline\n'
                                       + self._errors())
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in self.procs]
        if any(codes):
            raise RuntimeError(f'rank exit codes {codes}\n' + self._errors())
        with open(os.path.join(self.workdir, 'rank0.pkl'), 'rb') as f:
            self._result = pickle.load(f)
        return self._result


def spawn_ranks(target, world, workdir, args=(), timeout=120,
                backend='gloo'):
    """Start ``world`` ranks running target(rank, world, *args) (a function
    of this module) in a ``backend`` group; returns their Ranks handle."""
    return Ranks(target, world, workdir, args, timeout, backend)


# ---- helpers of the cases ------------------------------------------------
def models():
    from lightweaver_tpu_torch import CaII_atom, H_6_atom
    return [H_6_atom(), CaII_atom()]


def _raises(fn, match=''):
    """The message of the ValueError fn raises ('' if it does not)."""
    try:
        fn()
    except ValueError as e:
        return str(e) if match in str(e) else f'wrong message: {e}'
    return ''


# ---- columns and wavelengths (tests/test_torch_distributed.py) ------------
COLUMNS_C, COLUMNS_NK, COLUMNS_STEPS = 8, 16, 5


def columns_case(rank, world, shapes=((2, 2), (4, 1)), device='cpu'):
    """test_column_batch.py:68-87 on each mesh shape (the (2, 2) and the
    (4, 1) mesh): 8 columns of 16 depths, Ca active, 2 rays, 5 MALI steps
    + stat_equil; the gathered pops, J and I, dJ and dPops of each step, J
    after the first step; and the mesh refusals."""
    from lightweaver_tpu_torch.parallel import ColumnBatch, make_mesh
    from lightweaver_tpu_torch.problems import stacked_falc
    out = {}
    for shape in shapes:
        mesh = make_mesh(*shape, device=device)
        b = ColumnBatch.from_stacked(*stacked_falc(COLUMNS_C, COLUMNS_NK),
                                     models, ('Ca',), Nrays=2, mesh=mesh,
                                     device=device)
        steps = []
        for i in range(COLUMNS_STEPS):
            ju = b.formal_sol_gamma_matrices()
            if i == 0:
                J1 = b.J
            pu = b.stat_equil()
            steps.append((ju.dJMax, pu.dPopsMax))
        out[shape] = {'pops': b.pops, 'J': b.J, 'I': b.I, 'J1': J1,
                      'steps': steps, 'nIterCol': b.nIterCol,
                      'block': (b.Ncol, b.cfg.lamLo, b.cfg.lamHi)}
    out['raises'] = {
        'mesh_size': _raises(lambda: make_mesh(3, 2, device=device),
                             f'3 x 2 != {world}'),
        'uneven': _raises(lambda: ColumnBatch.from_stacked(
            *stacked_falc(5, 8), models, ('Ca',), Nrays=2,
            mesh=make_mesh(world, 1, device=device), device=device),
            'split evenly')}
    return out


OPTIONS_C = 4


def options_batch(option, mesh=None, device='cpu'):
    """tests/test_torch_columns_prd.py's batches at OPTIONS_C columns:
    'ng_charge' (H 6 + Ca II, H active, 16 depths, Ng(2, 2, 4),
    accelerateScattering, conserveCharge) or 'prd' / 'hprd' (H 6 alone,
    24 depths, the last columns with outflows, accelerateScattering)."""
    from lightweaver_tpu_torch import H_6_atom
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.problems import column_batch
    if option == 'ng_charge':
        return column_batch(OPTIONS_C, Nk=16, seed=3, Nrays=3,
                            activeSpecies=('H',), device=device, mesh=mesh,
                            conserveCharge=True, accelerateScattering=True,
                            ngOptions=NgOptions(2, 2, 4))
    vlos = np.linspace(0.0, 1.0, OPTIONS_C)[:, None] * np.linspace(
        5e3, 0.0, 24)[None, :]
    return column_batch(OPTIONS_C, models=lambda: [H_6_atom()],
                        activeSpecies=('H',), Nk=24, spread=0.0, vlos=vlos,
                        Nrays=3, device=device, mesh=mesh,
                        hprd=option == 'hprd', accelerateScattering=True)


def options_run(option, b):
    """tests/test_torch_columns_prd.py's schedules: 8 MALI steps with
    stat_equil from the third, or 4 rounds of a MALI step, stat_equil and
    prd_redistribute(maxIter=2).  Returns pops, J, ne and dRho/dJ per
    step."""
    steps = []
    for it in range(8 if option == 'ng_charge' else 4):
        ju = b.formal_sol_gamma_matrices()
        if option == 'ng_charge':
            if it >= 2:
                steps.append((ju.dJMax, b.stat_equil().dPopsMax))
        else:
            b.stat_equil()
            steps.append((ju.dJMax, b.prd_redistribute(maxIter=2).dRho[0]))
    return {'pops': b.pops[0], 'J': b.J, 'ne': b.ne, 'steps': steps}


def columns_options_case(rank, world):
    """options_run of each option on a (2, 1) mesh: every option the
    single-device batch takes runs per rank unchanged."""
    from lightweaver_tpu_torch.parallel import make_mesh
    mesh = make_mesh(world, 1, device='cpu')
    return {option: options_run(option, options_batch(option, mesh))
            for option in ('ng_charge', 'prd', 'hprd')}


LAMBDA_SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
                  'mali_full_precond_fused')


def falc24_arrays():
    """test_wavelength_sharding.py's problem as one stacked column: FAL-C
    at 24 depths with its vlos."""
    from lightweaver_tpu_torch import Falc82
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, 24).astype(int))
    return tuple(a[idx] if k == 0 else a[idx][None, :].copy()
                 for k, a in enumerate((full.height, full.temperature,
                                        full.vlos, full.vturb, full.ne,
                                        full.nHTot)))


def wavelength_case(rank, world):
    """One MALI step of the 24-depth column on a (1, 2) mesh under each
    scheme: J, dJ, Gamma and the rates; then two more steps with
    stat_equil under the default scheme."""
    from lightweaver_tpu_torch.parallel import ColumnBatch, make_mesh
    mesh = make_mesh(1, 2, device='cpu')
    out = {}
    for scheme in LAMBDA_SCHEMES:
        b = ColumnBatch.from_stacked(*falc24_arrays(), models, ('Ca',),
                                     Nrays=3, mesh=mesh, device='cpu',
                                     fsIterScheme=scheme)
        ju = b.formal_sol_gamma_matrices()
        out[scheme] = {
            'J': b.J[0], 'dJ': ju.dJMax, 'I': b.I[0],
            'Gamma': [g.numpy() for g in b._Gamma],
            'Rij': [[r.numpy() for r in rs] for rs in b._Rij],
            'block': (b.cfg.lamLo, b.cfg.lamHi)}
        if scheme == LAMBDA_SCHEMES[0]:
            b.stat_equil()
            for _ in range(2):
                b.formal_sol_gamma_matrices()
                b.stat_equil()
            out['steps3'] = {'pops': b.pops[0][0], 'J': b.J[0]}
    return out


LAMBDA_PRD_C, LAMBDA_PRD_NK, LAMBDA_PRD_ROUNDS = 2, 24, 4
# the PRD variants of lambda_prd_case: (name, scheme, hprd)
LAMBDA_PRD_CASES = tuple((f'prd-{s}', s, False) for s in LAMBDA_SCHEMES) \
    + (('hprd', LAMBDA_SCHEMES[0], True),)


def lambda_prd_arrays(hprd):
    """tests/test_column_batch.py:139-186's atmosphere at LAMBDA_PRD_C
    columns: FAL-C at 24 depths, identical columns, static, or under
    hybrid PRD the outflows of problems.column_vlos_ramps."""
    from lightweaver_tpu_torch.problems import (column_vlos_ramps,
                                                stacked_falc)
    h, T, v, vt, ne, nH = stacked_falc(LAMBDA_PRD_C, LAMBDA_PRD_NK,
                                       spread=0.0)
    vlos = (column_vlos_ramps(h, LAMBDA_PRD_C) if hprd
            else np.zeros_like(T))
    return h, T, vlos, vt, ne, nH


def lambda_prd_batch(scheme, hprd, mesh=None, device='cpu'):
    """The H 6 PRD batch of tests/test_column_batch.py:139-186 (Ly-alpha
    and Ly-beta in PRD) with Ca II active too, 3 rays,
    accelerateScattering: H 6 alone has 501 wavelengths, which the JAX
    package's make_mesh(1, 2) does not split; with Ca II 1046, and the
    second block (from 397 nm) holds no PRD row."""
    from lightweaver_tpu_torch.parallel import ColumnBatch
    return ColumnBatch.from_stacked(
        *lambda_prd_arrays(hprd), models, ('H', 'Ca'), Nrays=3, mesh=mesh,
        device=device, fsIterScheme=scheme, hprd=hprd,
        accelerateScattering=True)


def batch_state(b):
    """A batch's J of the whole grid and its populations, rho and JRest
    (whole on every rank of a wavelength axis of one column rank)."""
    return {'J': b._lam_rows(b.params['J'], 0).clone(),
            'pops': [p.clone() for p in b.params['pops']],
            'rho': [[None if r is None else r.clone() for r in rs]
                    for rs in b.params['rhoPrd']],
            'JRest': None if b.JRest is None else b.JRest.clone()}


def set_batch_state(b, st):
    """Put batch_state ``st`` into the unsharded batch b (rho in place:
    the params' rho is the flat Context's)."""
    b.params['J'] = st['J'].clone()
    b.params['pops'] = [p.clone() for p in st['pops']]
    for ai, rs in enumerate(st['rho']):
        for ti, r in enumerate(rs):
            if r is not None:
                b.params['rhoPrd'][ai][ti] = r.clone()
    b.JRest = None if st['JRest'] is None else st['JRest'].clone()


def prd_round(b):
    """One round: a MALI step, stat_equil, prd_redistribute(maxIter=2)."""
    b.formal_sol_gamma_matrices()
    b.stat_equil()
    b.prd_redistribute(maxIter=2)


def round_errors(b, u, J, I):
    """The difference of the sharded batch b (J and the emergent I of the
    whole grid) from the unsharded u after the same round: per row (the
    largest difference in a row over the row's largest value) for rho
    (rows of its window), J and I (per wavelength) and JRest; elementwise
    (relative) for the populations and the PRD lines' rates."""
    def rel(x, y):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        return float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300)))

    def rows(x, y):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        x, y = x.reshape(len(x), -1), y.reshape(len(y), -1)
        return float((np.abs(x - y).max(axis=1)
                      / np.abs(y).max(axis=1)).max())
    lines = u.flatCtx._prd_lines()
    err = {'rho': max(rows(b.params['rhoPrd'][ai][ti],
                           u.params['rhoPrd'][ai][ti])
                      for ai, ti, a, t in lines),
           'J': rows(J, u.params['J']),
           'I': rows(I.transpose(0, 1), u._I.transpose(0, 1)),
           'pops': max(rel(p, q) for p, q in zip(b.params['pops'],
                                                  u.params['pops'])),
           'rates': max(max(rel(b._Rij[ai][ti], u._Rij[ai][ti]),
                            rel(b._Rji[ai][ti], u._Rji[ai][ti]))
                        for ai, ti, a, t in lines)}
    if u.JRest is not None:
        err['JRest'] = rows(b.JRest, u.JRest)
    return err


def lambda_prd_case(rank, world):
    """Each LAMBDA_PRD_CASES variant on a (1, 2) mesh, LAMBDA_PRD_ROUNDS
    rounds (prd_round): in lockstep, rank 0 runs each round of the
    unsharded batch from the sharded batch's state before it and records
    round_errors; the free-running sharded rho and populations; the rows
    of each rank's block and of its PRD subset solve."""
    from lightweaver_tpu_torch.parallel import make_mesh
    mesh = make_mesh(1, world, device='cpu')
    out = {}
    for name, scheme, hprd in LAMBDA_PRD_CASES:
        b = lambda_prd_batch(scheme, hprd, mesh)
        u = lambda_prd_batch(scheme, hprd) if rank == 0 else None
        errs = []
        for _ in range(LAMBDA_PRD_ROUNDS):
            st = batch_state(b)
            prd_round(b)
            J, I = b._lam_rows(b.params['J'], 0), b._lam_rows(b._I, 1)
            if u is not None:
                set_batch_state(u, st)
                prd_round(u)
                errs.append(round_errors(b, u, J, I))
        lines = b.flatCtx._prd_lines()
        out[name] = {
            'errs': errs,
            'rho': [b.params['rhoPrd'][ai][ti].numpy()
                    for ai, ti, a, t in lines],
            'pops': b.pops[0],
            'rows': dist_gather_obj((b.cfg.lamLo, b.cfg.lamHi,
                                     len(b._prd_fs.rows)))}
    return out


MULTIHOST_C, MULTIHOST_NK, MULTIHOST_STEPS = 8, 16, 4


def multihost_arrays():
    """multihost_worker.py's global columns: FAL-C at 16 depths, per-column
    temperature scales 1 + 0.05 N(0, 1) from seed 0."""
    from lightweaver_tpu_torch import Falc82
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, MULTIHOST_NK).astype(int))
    Nk = len(idx)
    rng = np.random.default_rng(0)
    scale = 1.0 + 0.05 * rng.standard_normal((MULTIHOST_C, 1))

    def rep(a):
        return np.broadcast_to(a[idx], (MULTIHOST_C, Nk)).copy()
    return (full.height[idx], full.temperature[idx][None, :] * scale,
            rep(full.vlos), rep(full.vturb), rep(full.ne), rep(full.nHTot))


def multihost_run(batch, steps):
    """multihost_worker.py's schedule: MALI steps, stat_equil from the
    second on."""
    for i in range(steps):
        batch.formal_sol_gamma_matrices()
        if i >= 1:
            batch.stat_equil()
    return batch


def multihost_case(rank, world, converge=False):
    """The multihost pipeline on 2 ranks: global_mesh, local_column_slice,
    make_global_array's round trip, and the two-process batch against the
    unsharded run of every column on each rank (converge: iterate both to
    convergence)."""
    from torch.distributed.tensor import Replicate, Shard

    from lightweaver_tpu_torch.parallel import ColumnBatch
    from lightweaver_tpu_torch.parallel import multihost as mh
    mh.initialize_multihost(num_processes=world, backend='gloo')  # no-op
    mesh = mh.global_mesh(device='cpu')
    mesh2 = mh.global_mesh(nWavelength=2, device='cpu')
    sl = mh.local_column_slice(MULTIHOST_C)
    data = np.arange(16.0).reshape(16, 1) * np.ones((16, 5))
    arr = mh.make_global_array(data[rank * 8:(rank + 1) * 8], mesh,
                               [Shard(0), Replicate()])
    arrays = multihost_arrays()

    def batch(m):
        return ColumnBatch.from_stacked(*arrays, models, ('Ca',), Nrays=2,
                                        mesh=m, device='cpu')
    if converge:
        bS, bU = batch(mesh), batch(None)
        nS, nU = bS.iterate(NmaxIter=300), bU.iterate(NmaxIter=300)
        out = {'nIter': (nS, nU), 'nIterCol': (bS.nIterCol, bU.nIterCol)}
    else:
        bS = multihost_run(batch(mesh), MULTIHOST_STEPS)
        bU = multihost_run(batch(None), MULTIHOST_STEPS)
        out = {}
    errs = [float(np.abs(a / b - 1.0).max())
            for a, b in zip(bS.pops, bU.pops)]
    out.update({
        'shapes': (tuple(mesh.mesh.shape), mesh.mesh_dim_names,
                   tuple(mesh2.mesh.shape)),
        'slices': [(s.start, s.stop) for s in dist_gather_obj(sl)],
        'block': (bS.Ncol, bS.flatCtx.atmos.Nspace),
        'roundtrip': arr.full_tensor().numpy(), 'data': data,
        'popsErr': max(errs), 'pops': bS.pops, 'J': bS.J,
        'raises': _raises(lambda: mh.global_mesh(3, device='cpu'),
                          'mesh 3x1 != 2 ranks')})
    return out


def dist_gather_obj(x):
    """Every rank's picklable x."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


# ---- the x-sharded 2D sweep and Context (tests/test_torch_xshard2d.py) ----
XS_NZ, XS_NX, XS_B = 12, 16, 5


def xshard_problem(seed=0):
    """tests/test_xshard2d.py:make_problem (numpy)."""
    rng = np.random.default_rng(seed)
    z = np.linspace(2.0e6, 0.0, XS_NZ)
    x = np.linspace(0.0, 1.0e6, XS_NX)
    zz = np.linspace(0, 1, XS_NZ)[None, :, None]
    xx = np.linspace(0, 2 * np.pi, XS_NX)[None, None, :]
    lam = np.linspace(0.5, 2.0, XS_B)[:, None, None]
    chi = (1e-7 * lam * np.exp(6.0 * zz) * (1.1 + 0.3 * np.sin(xx)) + 1e-9)
    S = lam * (1.0 + 0.5 * zz + 0.2 * np.cos(xx + zz))
    chi += 1e-8 * rng.random((XS_B, XS_NZ, XS_NX))
    Iupw = np.ascontiguousarray(S[:, -1] * (1.0 + 0.1 * np.sin(xx[0])))
    return x, z, chi, S, Iupw


def xshard_ibc():
    return (1.0 + 0.3 * np.cos(np.linspace(0, 3, XS_NZ))[None, :]
            * np.linspace(0.5, 2.0, XS_B)[:, None])


def xshard_cases():
    """The cases of tests/test_xshard2d.py: (name, mux, muz, periodic,
    interp, alongRay, seed)."""
    cases = []
    for mux, muz in ((0.6, 0.8), (-0.6, 0.8), (0.3, -0.95)):
        for interp in ('linear', 'besser'):
            for along in ('linear', 'besser'):
                cases.append((f'periodic-{interp}-{along}-{mux}-{muz}', mux,
                              muz, True, interp, along, 0))
    for mux in (0.6, -0.6):
        for interp in ('linear', 'besser'):
            for along in ('linear', 'besser'):
                cases.append((f'callable-{interp}-{along}-{mux}', mux, 0.8,
                              False, interp, along, 1))
    cases.append(('vertical', 0.0, 1.0, True, 'linear', 'linear', 2))
    return cases


def xshard_case(rank, world):
    """Every case of xshard_cases through formal_sol_2d_xsharded on a
    4-rank x mesh, gathered to the whole grid; and the refusal of
    single-column shards."""
    from lightweaver_tpu_torch.ops.formal_solver2d import build_geometry_2d
    from lightweaver_tpu_torch.parallel.xshard2d import (
        formal_sol_2d_xsharded, make_x_mesh)
    mesh = make_x_mesh(device='cpu')
    group = mesh.get_group('x')
    out = {}
    for name, mux, muz, periodic, interp, along, seed in xshard_cases():
        x, z, chi, S, Iupw = xshard_problem(seed)
        geom = build_geometry_2d(x, z, mux, muz, muz > 0, periodic=periodic)
        Ibc = None if periodic else torch.as_tensor(xshard_ibc())
        res = formal_sol_2d_xsharded(
            torch.as_tensor(chi), torch.as_tensor(S), geom,
            torch.as_tensor(Iupw), mesh, interp=interp, periodic=periodic,
            Ibc=Ibc, alongRay=along)
        out[name] = [_gather_x(r, group).numpy() for r in res]
    x, z, chi, S, Iupw = xshard_problem()
    geom = build_geometry_2d(x, z, 0.6, 0.8, True, periodic=True)
    out['single_column'] = _raises(lambda: formal_sol_2d_xsharded(
        torch.as_tensor(chi[..., :4]), torch.as_tensor(S[..., :4]), geom,
        torch.as_tensor(Iupw[..., :4]), mesh), '>= 2 columns')
    return out


def _gather_x(x, group):
    """A rank's block [..., n] of the last axis as the whole [..., p n]."""
    blocks = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(blocks, x.contiguous(), group=group)
    return torch.cat(blocks, dim=-1)


CTX_NZ, CTX_NX, CTX_STEPS = 16, 8, 3


class FixedXBc:
    """A callable x boundary returning fixed data [Nlam, Nmu, 2, Nz]."""

    def __init__(self, data):
        self.data = data

    def compute_bc(self, atmos, spect):
        return self.data


def context_2d(Nz=CTX_NZ, Nx=CTX_NX, mesh=None, xBcData=None,
               device='cpu', active=('Ca',), field=False, **ctxKw):
    """tests/test_context_2d_xsharded.py:_make on the port, on the CPU:
    FAL-C at Nz depths, Nx columns 200 km apart with a 10% sinusoidal
    temperature perturbation along x, H 6 + Ca II (``active`` active; Ca
    by default), 3 rays; ``field``: in problems.magnetise's field."""
    from lightweaver_tpu_torch import Atmosphere, Falc82, RadiativeSet
    from lightweaver_tpu_torch.context import Context
    from lightweaver_tpu_torch.problems import magnetise
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nz).astype(int))
    Nz = len(idx)
    x = np.arange(Nx) * 2e5

    def bc(a):
        return np.broadcast_to(a[:, None], (Nz, Nx)).copy()
    T = bc(full.temperature[idx])
    T = T * (1.0 + 0.1 * np.sin(2 * np.pi * np.arange(Nx) / Nx)[None, :])
    kw = {}
    if xBcData is not None:
        kw['xLowerBc'] = FixedXBc(xBcData)
        kw['xUpperBc'] = FixedXBc(xBcData)
    atmos = Atmosphere.make_2d(
        height=full.height[idx], x=x, temperature=T,
        vx=np.zeros((Nz, Nx)), vz=bc(full.vlos[idx]),
        vturb=bc(full.vturb[idx]), ne=bc(full.ne[idx]),
        nHTot=bc(full.nHTot[idx]), **kw)
    atmos.quadrature(3)
    if field:
        magnetise(atmos)
    rs = RadiativeSet(models())
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, mesh=mesh, device=device, **ctxKw)


CTX_CASES = {
    'periodic_linear': {},
    'periodic_besser': {'formalSolver': 'piecewise_besser_2d',
                        'interpFn2d': 'interp_besser_2d'},
    'callable_besser': {'formalSolver': 'piecewise_besser_2d',
                        'interpFn2d': 'interp_besser_2d', 'xBc': True},
}


def context_steps(ctx, steps):
    """MALI steps, each followed by stat_equil (test_context_2d_xsharded's
    callable-x-BC protocol): dJ and dPops per step."""
    out = []
    for _ in range(steps):
        ju = ctx.formal_sol_gamma_matrices()
        pu = ctx.stat_equil()
        out.append((float(ju.dJMax), pu.dPopsMax))
    return out


def context_converge(ctx, maxIter=400):
    """test_context_2d_xsharded.py:_converge: the iteration count."""
    for it in range(maxIter):
        ju = ctx.formal_sol_gamma_matrices()
        if it < 3:
            continue
        pu = ctx.stat_equil()
        if float(ju.dJMax) < 5e-3 and pu.dPopsMax < 1e-3:
            return it
    raise AssertionError('no convergence')


def context_2d_case(rank, world, xBcData, converge=False, device='cpu'):
    """The x-sharded 2D Context on a 4-rank x mesh: CTX_STEPS MALI steps
    (converge: to convergence) of each CTX_CASES entry, with the gathered
    pops, J and I; and the refusals of a 1D atmosphere and of an Nx the
    ranks do not divide."""
    from lightweaver_tpu_torch.parallel.xshard2d import make_x_mesh
    mesh = make_x_mesh(device=device)
    out = {}
    for name, kw in CTX_CASES.items():
        kw = dict(kw)
        bcData = xBcData if kw.pop('xBc', False) else None
        if converge and name != 'periodic_linear':
            continue
        ctx = context_2d(mesh=mesh, xBcData=bcData, device=device, **kw)
        xs = ctx.cfg.xShard
        if converge:
            res = {'nIter': context_converge(ctx)}
        else:
            n0 = xs.collectives
            steps = context_steps(ctx, 1)
            res = {'J1': ctx.gather_x(ctx.J).cpu().numpy(),
                   'collectives': xs.collectives - n0}
            res['steps'] = steps + context_steps(ctx, CTX_STEPS - 1)
        res.update({'pops': ctx.gather_x(ctx.popsState[0]['n']).cpu()
                    .numpy(),
                    'J': ctx.gather_x(ctx.J).cpu().numpy(),
                    'I': ctx.gather_x(ctx.I).cpu().numpy(),
                    'activePops': ctx.activePops['Ca'],
                    'block': (ctx.cfg.Nx, ctx.cfg.Nk)})
        out[name] = res
    if not converge and device == 'cpu':
        from lightweaver_tpu_torch import Atmosphere, Falc82, RadiativeSet
        from lightweaver_tpu_torch.context import Context

        def one_d():
            full = Falc82()
            idx = np.unique(np.linspace(0, 81, 10).astype(int))
            atmos = Atmosphere(height=full.height[idx],
                               temperature=full.temperature[idx],
                               vlos=full.vlos[idx], vturb=full.vturb[idx],
                               ne=full.ne[idx], nHTot=full.nHTot[idx])
            atmos.quadrature(3)
            rs = RadiativeSet(models())
            rs.set_active('Ca')
            Context(atmos, rs.compute_wavelength_grid(),
                    rs.compute_eq_pops(atmos), mesh=mesh, device='cpu')
        out['raises'] = {
            'one_d': _raises(one_d, 'only supported for 2D'),
            'divisible': _raises(lambda: context_2d(Nx=6, mesh=mesh),
                                 'divisible')}
    return out


# ---- the x-sharded Context's options (tests/test_torch_xshard2d_options.py)
XO_STEPS = 4
# the x-sharded Context's options, each a case of xshard_option_run
XO_FEATURES = ('ng', 'escape', 'charge', 'prd', 'hprd', 'update_deps',
               'state_dict', 'compute_rays', 'stokes', 'iterate_on_device',
               'od_prd')
# Ng of the 'ng' case: the first extrapolation at the third iterate
XO_NG = (2, 3, 3)
# Ng of the 'iterate_on_device' case (tests/test_torch_on_device.py's:
# an extrapolation as early as XO_NG's makes the slab's populations
# explode), and the loops' JTol = popsTol: the slab converges in 33
# iterations (202 at the default 5e-3 / 1e-3, which Ng does not shorten)
XO_OD_NG, XO_OD_TOL = (2, 5, 8), 0.1
# the loops' cap
XO_OD_MAX = 100


def xshard_option_context(feature, mesh=None, device='cpu'):
    """context_2d (the 16 x 8 slab) configured for ``feature``: Ng
    XO_NG; the escape-probability start; H 6 active with conserveCharge;
    H 6 active with PRD lines (hybrid PRD for 'hprd'); a magnetised slab
    for 'stokes'."""
    from lightweaver_tpu_torch.ops.ng import NgOptions
    from lightweaver_tpu_torch.utils import InitialSolution
    kw = {}
    if feature == 'ng':
        kw['ngOptions'] = NgOptions(*XO_NG)
    elif feature == 'escape':
        kw['initSol'] = InitialSolution.EscapeProbability
    elif feature == 'iterate_on_device' and mesh is None:
        # the host loop the on-device one is held to
        kw['ngOptions'] = NgOptions(*XO_OD_NG)
    elif feature == 'charge':
        kw.update(active=('H',), conserveCharge=True)
    elif feature in ('prd', 'hprd', 'od_prd'):
        kw.update(active=('H',), hprd=feature == 'hprd')
    elif feature == 'stokes':
        kw['field'] = True
    return context_2d(mesh=mesh, device=device, **kw)


def xo_host_loop(ctx, NmaxIter=XO_OD_MAX, tol=XO_OD_TOL):
    """The host MALI loop of tests/test_torch_on_device.py (stat_equil
    past the 3-step warm-up) to dJ and dPops < tol: its iteration
    count."""
    for it in range(NmaxIter):
        ju = ctx.formal_sol_gamma_matrices()
        if it < 3:
            continue
        pu = ctx.stat_equil()
        if float(ju.dJMax) < tol and pu.dPopsMax < tol:
            break
    return it + 1


def xshard_option_run(feature, ctx):
    """``feature``'s protocol on ctx (x-sharded or not; every rank of an
    x group runs it): the whole grid's populations and J after it, and
    its own numbers."""
    import pickle
    from lightweaver_tpu_torch.ops.ng import NgOptions

    def whole(x):
        return ctx.gather_x(x).cpu().numpy()
    out = {}
    if feature in ('ng', 'charge'):
        out['steps'], out['accelerated'] = [], []
        for _ in range(XO_STEPS):
            ju = ctx.formal_sol_gamma_matrices()
            pu = ctx.stat_equil()
            out['steps'].append((float(ju.dJMax), pu.dPopsMax))
            out['accelerated'].append(pu.ngAccelerated)
        out['ne'] = np.asarray(ctx.atmos.ne).copy()
    elif feature == 'escape':
        out['start'] = whole(ctx.popsState[0]['n'])
        out['nStar'] = whole(ctx.popsState[0]['nStar'])
        out['steps'] = context_steps(ctx, 2)
    elif feature in ('prd', 'hprd'):
        out['steps'] = []
        for _ in range(XO_STEPS):
            ju = ctx.formal_sol_gamma_matrices()
            ctx.stat_equil()
            u = ctx.prd_redistribute(maxIter=2)
            out['steps'].append((float(ju.dJMax), max(u.dRho)))
        out['rho'] = [whole(ctx.rhoPrd[ai][ti])
                      for ai, ti, a, t in ctx._prd_lines()]
    elif feature == 'update_deps':
        context_steps(ctx, 2)
        ctx.atmos.temperature *= 1.01
        ctx.update_deps()
        out['bg'] = [whole(x) for x in (ctx.bgChi, ctx.bgEta, ctx.bgSca,
                                        ctx.temperature,
                                        ctx.popsState[0]['nStar'])]
        out['steps'] = context_steps(ctx, 2)
    elif feature == 'state_dict':
        context_steps(ctx, 2)
        st = ctx.state_dict()
        out['state'] = {k: st[k] for k in ('J', 'I', 'pops', 'nStar')}
        out['kwargs'] = st['kwargs']
        back = pickle.loads(pickle.dumps(ctx))
        out['pickled'] = {'sharded': back.cfg.xShard is not None,
                          'Nx': back.cfg.Nx, 'J': back.J.numpy(),
                          'I': back.I.numpy(),
                          'pops': back.popsState[0]['n'].numpy()}
    elif feature == 'compute_rays':
        context_steps(ctx, 2)
        out['rays'] = ctx.compute_rays(mus=[1.0])
    elif feature == 'stokes':
        context_steps(ctx, 1)
        ctx.single_stokes_fs()
        out['I'], out['Quv'] = whole(ctx.I), whole(ctx.Quv)
    elif feature == 'iterate_on_device':
        if ctx.cfg.xShard is None:
            out['nIter'] = xo_host_loop(ctx)
        else:
            out['nIter'], out['dJ'], out['dPops'] = ctx.iterate_on_device(
                NmaxIter=XO_OD_MAX, JTol=XO_OD_TOL, popsTol=XO_OD_TOL,
                ngOptions=NgOptions(*XO_OD_NG))
    elif feature == 'od_prd':
        out['raises'] = _raises(
            lambda: ctx.iterate_on_device(NmaxIter=1, prd=True),
            'on-device PRD needs a 1D atmosphere')
    out['pops'] = whole(ctx.popsState[0]['n'])
    out['J'] = whole(ctx.J)
    return out


def xshard_options_case(rank, world, features=XO_FEATURES):
    """xshard_option_run of each feature on a 4-rank x mesh (2 columns
    each)."""
    from lightweaver_tpu_torch.parallel.xshard2d import make_x_mesh
    mesh = make_x_mesh(device='cpu')
    return {f: xshard_option_run(f, xshard_option_context(f, mesh))
            for f in features}


# ---- on the card (tests/test_torch_distributed_card.py) -----------------
def nccl_case(rank, world):
    """An 'nccl' group of one rank: all_reduce (sum, max, min), all_gather
    and broadcast of a CUDA tensor, and an 8-column batch on the (1, 1)
    mesh against the same batch without one (5 steps)."""
    from lightweaver_tpu_torch.parallel import ColumnBatch, multihost as mh
    from lightweaver_tpu_torch.problems import stacked_falc
    x = torch.arange(1.0, 5.0, dtype=torch.float64, device='cuda')
    ok = {}
    for op in ('SUM', 'MAX', 'MIN'):
        y = x.clone()
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op))
        ok[op] = bool(torch.equal(y, x))
    ys = [torch.empty_like(x)]
    dist.all_gather(ys, x)
    ok['all_gather'] = bool(torch.equal(ys[0], x))
    y = x.clone()
    dist.broadcast(y, 0)
    ok['broadcast'] = bool(torch.equal(y, x))
    runs = []
    for mesh in (mh.global_mesh(), None):
        b = ColumnBatch.from_stacked(*stacked_falc(COLUMNS_C, COLUMNS_NK),
                                     models, ('Ca',), Nrays=2, mesh=mesh)
        for _ in range(COLUMNS_STEPS):
            b.formal_sol_gamma_matrices()
            b.stat_equil()
        runs.append(b.pops[0])
    return {'backend': dist.get_backend(), 'ok': ok, 'pops': runs}
