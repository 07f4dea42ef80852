"""
KE: the per-m radial stack apply of the polar geometries.

Replaces the per-m batched einsums of dedalus_tpu (K13 of the ROADMAP, polar
part): DiskRadialBasis._apply_stack (core/basis_polar.py:525-527, the real
pair form) and PolarMOperator.operate with its Convert, Interpolate and
Lift counterparts (core/operators_polar.py:164-166, 342, 392, 457):

    out[b, m, p, o] (+)= sum_i S[m, o, i] * x[b, m, p, i]

for the M/2 azimuthal wavenumbers m of a RealFourier azimuth, its (cos,
-sin) pair slots p and a batch b of tensor components. The per-m stack S is
shared by the pair slots and the components.

Its signed form serves complex data on the signed (+m, -m) slots of an
ExponentialFourier azimuth (core/basis_polar.py:470-500, the einsums
'mpoi,...mpi->...mpo' of core/operators_polar.py:163 and 'mpon,mp...n->mp...o'
of core/basis_sphere.py:157): the stack S (K, 2, O, I) holds one real matrix
per slot, since spin-weighted functions differ between +m and -m. The
stacks are real and the data complex: the kernel reads the complex data as
its float64 (re, im) view, both parts taking the same products. A shared
(K, O, I) stack takes complex data the same way (the ball's lift and
interpolation, whose matrices depend on |m|).

CPU tensors run the plain twin; CUDA tensors launch csrc/polar_kernels.cu
ke_polar_apply_f64, one launch a call, with the plan of `ke_plan`. Each
stack entry is used once per (b, p) column, so the apply is bound by
reading the stack (50 MB for one disk transform stack at 128x256); the
kernel's warps stream the stack's rows once from HBM, each lane a batch of
16-byte loads in flight while it sums the last, against the components
staged in shared memory. Launches count per form (build.count): on
real data in `launches`, on complex data with a shared stack in
`launches_c128`, with a signed stack in `launches_signed`.
"""

import collections
import ctypes
import functools

import torch

# The launch geometry of KE's per-m apply: csrc/polar_kernels.cu's constants
# of the same names (its ke_geometry; polar_apply checks the two agree)
KE_THREADS = 256
KE_LOADS = 8                    # loads of S a lane's batch
KE_XS_BYTES = 48 * 1024         # staged x a block
KE_GEOMETRY = (KE_THREADS, KE_LOADS, KE_XS_BYTES)
KE_WARPS = KE_THREADS // 32
KE_COLUMNS = (2, 4, 8)          # columns a pass (the kernel's NC)
KE_SHORT_ROW = 512              # rows up to this long take 8 lanes, longer ones 16
KE_WARP_BATCHES = 4             # batches a row from which a block takes 8 warps
KE_ROW_GROUPS = 4               # row groups a warp (RI) where a row is one batch
KE_WARPS_AN_SM = 8              # the grid's warps an SM at least, where RI allows
# SMs of an H100 SXM: the plan's default where no device is named
H100_SMS = 132

KEPlan = collections.namedtuple('KEPlan',
                                'L V NC warps RI RT W nrange ntile blocks smem passes launches')


@functools.lru_cache(maxsize=None)
def ke_plan(K, O, I, ns, ncol, vec, sms=H100_SMS, slots=2):
    """
    The launch of KE's per-m apply for a (K, O, I) stack (ns = 1 shared, 2
    signed) and `ncol` (component, slot, re/im) columns a block (both slots'
    with a shared stack, one slot's with a signed one); `slots` the rows of
    x an m (2, or 1 where the azimuth has one point); `vec` where S's rows
    and x start 16-byte aligned (I even, S and x aligned). Fields, as the
    kernel's: L lanes a row (8 up to KE_SHORT_ROW elements: 4 rows of a warp
    share each read of x, 3 shuffle levels; 16 on longer rows); V doubles a
    load; NC columns a pass (`passes` passes where ncol > 8, inside the one
    launch); W row elements a staged range of x (the whole row where NC * I
    doubles fit in KE_XS_BYTES, else the most whole batches that fit),
    `nrange` ranges; `warps` warps a block (8 where a row is 4 batches or
    more: the staged x then serves twice the rows, else 4); RI row groups a
    warp, KE_ROW_GROUPS where a row is one batch (so that a warp has batches
    to stream one after another), else 1, halved while the grid would hold
    less than KE_WARPS_AN_SM warps an SM; RT = warps * (32 / L)
    * RI rows a block; blocks = K * signed slots * ntile. (The rules were read off
    chip_smoke.ke_sweep, which times each L, warps and RI at KE's named
    blocks on the card.)
    """
    V = 2 if vec else 1
    NC = next(c for c in KE_COLUMNS if c >= min(ncol, KE_COLUMNS[-1]))
    L = 8 if I <= KE_SHORT_ROW else 16
    nslot = slots if ns == 2 else 1
    step = L * V * KE_LOADS
    budget = KE_XS_BYTES // (8 * NC)
    W = -(-I // 2) * 2 if I <= budget else budget // step * step
    nb = -(-min(W, I) // step)              # batches a row takes in a range
    warps = KE_WARPS if nb >= KE_WARP_BATCHES else KE_WARPS // 2
    RI = KE_ROW_GROUPS if nb == 1 and W >= I else 1
    while RI > 1 and K * nslot * -(-O // (warps * (32 // L) * RI)) * warps < KE_WARPS_AN_SM * sms:
        RI //= 2
    RT = warps * (32 // L) * RI
    ntile = -(-O // RT)
    return KEPlan(L=L, V=V, NC=NC, warps=warps, RI=RI, RT=RT, W=W, nrange=-(-I // W),
                  ntile=ntile, blocks=K * nslot * ntile, smem=NC * W * 8,
                  passes=-(-ncol // NC), launches=1)


def azimuth_slots(S, M):
    """The azimuth rows an m of data with M azimuth rows under a stack of
    K = S.shape[0] m's: 2 (a cos/sin or +m/-m pair), or 1 where the azimuth
    has one point (M = 1: K = 1, the m = 0 row alone; the JAX package's
    P = max(M // 2, 1) slots of M // P rows). Raises on any other count."""
    K = S.shape[0]
    if M == 2 * K:
        return 2
    if M == 1 and K == 1:
        return 1
    raise ValueError(f"KE: {M} azimuth rows for a stack of {K} m's "
                     f"(2 an m, or 1 where the azimuth has one point)")


def _check_stack(S, device, what):
    if (S.dtype != torch.float64 or S.device != device or not S.is_contiguous()
            or S.dim() not in (3, 4) or (S.dim() == 4 and S.shape[1] != 2)):
        raise ValueError(f"KE: S must be a contiguous float64 (K, O, I) or signed "
                         f"(K, 2, O, I) tensor on {device} ({what})")


def polar_apply_plain(S, x, out=None, accumulate=False):
    """Plain torch KE (the JAX package's einsum), over the
    azimuth_slots rows an m (a signed stack's +m slot alone where
    there is one)."""
    lead = x.shape[:-2]
    K = S.shape[0]
    P = azimuth_slots(S, x.shape[-2])
    xm = x.reshape(lead + (K, P, x.shape[-1]))
    eq = 'mpoi,...mpi->...mpo' if S.dim() == 4 else 'moi,...mpi->...mpo'
    S = S[:, :P] if S.dim() == 4 else S
    # (torch's einsum does not mix real and complex operands)
    res = torch.einsum(eq, S.to(x.dtype), xm).reshape(lead + (P * K, S.shape[-2]))
    if out is None:
        return res
    if accumulate:
        out.add_(res)
    else:
        out.copy_(res)
    return out


def polar_apply(S, x, out=None, accumulate=False):
    """
    KE: apply the per-m stack S (K, O, I), or the signed stack (K, 2, O, I),
    to x (..., 2K, I) -> (..., 2K, O), or at one azimuth point x (..., 1, I)
    -> (..., 1, O) (K = 1: azimuth_slots); x float64 or complex128. With `out`
    given (contiguous, of that shape) the result is written into it, or
    added to it when `accumulate`, so an operator summing several component
    pairs into one output makes no extra pass.
    """
    if x.device.type == 'cpu':
        return polar_apply_plain(S, x, out, accumulate)
    from ..csrc import build
    _check_stack(S, x.device, 'polar_apply')
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    ns = S.dim() - 2
    lead = tuple(x.shape[:-2])
    P = azimuth_slots(S, x.shape[-2]) if x.dim() >= 2 else 2
    if (x.dtype not in (torch.float64, torch.complex128) or tuple(x.shape[-2:]) != (P * K, I)
            or not x.is_contiguous()):
        raise ValueError(f"KE: x must be a contiguous float64 or complex128 (..., {P * K}, {I}) "
                         f"tensor")
    if out is None:
        if accumulate:
            raise ValueError("KE: accumulate needs an output tensor")
        out = torch.empty(lead + (P * K, O), dtype=x.dtype, device=x.device)
    elif (out.dtype != x.dtype or out.device != x.device
            or tuple(out.shape) != lead + (P * K, O) or not out.is_contiguous()):
        raise ValueError(f"KE: out must be a contiguous {x.dtype} {lead + (P * K, O)} tensor")
    B = 1
    for n in lead:
        B *= n
    build.check_geometry('ke_geometry', KE_GEOMETRY)
    _ke_launch(build.library(), S, x, out, accumulate,
               torch.cuda.current_stream(x.device).cuda_stream, _sms(x.device), B)
    build.count(polar_apply, 'signed' if ns == 2 else x.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ke_launch(lib, S, x, out, accumulate, stream, sms, B):
    """One launch of ke_polar_apply_f64 through `lib` on checked tensors,
    with the plan of ke_plan; returns the plan."""
    from ..csrc import build
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    ns = S.dim() - 2
    nc = 2 if x.is_complex() else 1
    P = azimuth_slots(S, x.shape[-2])
    plan = ke_plan(K, O, I, ns, B * nc * (1 if ns == 2 else P),
                   I % 2 == 0 and S.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0, sms, P)
    build.check(lib.ke_polar_apply_f64(
        S.data_ptr(), x.data_ptr(), out.data_ptr(), B, K, O, I, ns, P, nc, plan.L, plan.V,
        plan.NC, plan.warps, plan.RI, plan.W, int(accumulate), stream), 'polar_apply')
    return plan


polar_apply.launches = polar_apply.launches_c128 = polar_apply.launches_signed = 0


# KE's trailing form (csrc/polar_kernels.cu trailing_apply_kernel): its
# constants of the same names (kt_geometry; trailing_apply checks the two agree)
KT_WARPS = 4            # most warps a block, a 32-column strip each
KT_WN = 32              # columns a warp (4 n-tiles of 8)
KT_KC = 16              # reduction depth a step (one m16n8k16 f64 product)
KT_STAGES = 3           # ring stages
KT_SS = KT_KC + 4       # S tile row stride (doubles)
KT_MAX_MT = 4           # m16 tiles of rows a block
KT_MAX_COMPS = 9        # components a launch
KT_GEOMETRY = (KT_WARPS, KT_WN, KT_KC, KT_STAGES, KT_SS, KT_MAX_MT, KT_MAX_COMPS)
KT_BLOCKS_AN_SM = 2     # the grid's blocks an SM at least, where row tiles allow

KTPlan = collections.namedtuple('KTPlan', 'MT RT NW CT nct nrt V ncol blocks smem nk')


@functools.lru_cache(maxsize=None)
def kt_plan(K, O, I, ns, ncomps, T, vec, sms=H100_SMS, slots=2):
    """
    The launch of KE's trailing form for a (K, O, I) stack (ns = 1 shared by
    both slots, 2 signed), `ncomps` components and T doubles a trailing row
    (2T on complex data); `vec` where T and I are even and S, x and out
    16-byte aligned (V = 2: 16-byte copies and pair stores); `slots` the
    azimuth rows of x an m (2, the cos/sin or +m/-m pair; 1 where the
    azimuth has one point). A block is (m, signed slot, row tile of
    RT = 16 MT rows, column tile of CT = 32 NW columns); the `ncol` columns
    of one (m, slot) product (ncomps x slots x T with a shared stack,
    ncomps x T a slot with a signed one) split into `nct` tiles of at most
    KT_WARPS warps, NW the fewest warps that hold an equal share. MT: among
    1 to KT_MAX_MT, those whose grid holds KT_BLOCKS_AN_SM blocks an SM; of
    them the one that pads O least, the larger on a tie (where none does,
    1). `nk` steps of KT_KC along I; `smem` the bytes a block takes (the
    ring and the column table).
    """
    nslot = slots if ns == 2 else 1
    ncol = ncomps * (1 if ns == 2 else slots) * T
    nct = -(-ncol // (KT_WARPS * KT_WN))
    NW = -(-ncol // (nct * KT_WN))
    CT = NW * KT_WN
    best = None
    for MT in range(KT_MAX_MT, 0, -1):
        nrt = -(-O // (16 * MT))
        if K * nslot * nct * nrt < KT_BLOCKS_AN_SM * sms:
            continue
        if best is None or nrt * 16 * MT < best[1]:
            best = (MT, nrt * 16 * MT)
    MT = 1 if best is None else best[0]
    nrt = -(-O // (16 * MT))
    smem = 8 * (KT_STAGES * (16 * MT * KT_SS + KT_KC * (CT + 4)) + 2 * CT)
    return KTPlan(MT=MT, RT=16 * MT, NW=NW, CT=CT, nct=nct, nrt=nrt, V=2 if vec else 1,
                  ncol=ncol, blocks=K * nslot * nct * nrt, smem=smem, nk=-(-I // KT_KC))


def trailing_apply_plain(S, x, out, comps, accumulate=False):
    """Plain torch KE, trailing form (the JAX package's einsum
    'mon,mp...n->mp...o', or 'mpon,mp...n->mp...o' on a signed stack),
    over the azimuth_slots rows an m (a signed stack's +m slot alone
    where there is one)."""
    K = S.shape[0]
    P = azimuth_slots(S, x.shape[1])
    eq = 'mpoi,mpit->mpot' if S.dim() == 4 else 'moi,mpit->mpot'
    S = S.to(x.dtype)
    if S.dim() == 4:
        S = S[:, :P]
    for c in comps:
        xm = x[c].reshape((K, P) + tuple(x.shape[2:]))
        res = torch.einsum(eq, S, xm).reshape(out.shape[1:])
        if accumulate:
            out[c].add_(res)
        else:
            out[c].copy_(res)
    return out


def trailing_apply(S, x, out, comps, accumulate=False):
    """
    KE, trailing form: apply the per-m stack S (K, O, I), or the signed
    stack (K, 2, O, I), along the second axis of the components `comps` of
    x (C, 2K, I, T) into out (C, 2K, O, T), the trailing axis T (a ball's
    radius) batched through the product and read in place: one launch per
    KT_MAX_COMPS components (one a call for any tensor up to rank 2), with
    the plan of kt_plan. Complex data rides as its (re, im) view, the pair
    on the trailing axis (2T columns). `accumulate` as in polar_apply.
    """
    comps = [int(c) for c in comps]
    if x.device.type == 'cpu':
        return trailing_apply_plain(S, x, out, comps, accumulate)
    from ..csrc import build
    _check_stack(S, x.device, 'trailing_apply')
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    ns = S.dim() - 2
    C, T = x.shape[0], x.shape[-1]
    P = azimuth_slots(S, x.shape[1]) if x.dim() == 4 else 2
    if (x.dtype not in (torch.float64, torch.complex128) or x.dim() != 4
            or tuple(x.shape[1:3]) != (P * K, I) or not x.is_contiguous()):
        raise ValueError(f"KE: x must be a contiguous float64 or complex128 "
                         f"(C, {P * K}, {I}, T) tensor")
    if (out.dtype != x.dtype or out.device != x.device
            or tuple(out.shape) != (C, P * K, O, T) or not out.is_contiguous()):
        raise ValueError(f"KE: out must be a contiguous {x.dtype} {(C, P * K, O, T)} tensor")
    if not comps or not all(0 <= c < C for c in comps):
        raise ValueError("KE: a component index is out of range")
    build.check_geometry('kt_geometry', KT_GEOMETRY)
    Td = 2 * T if x.is_complex() else T
    vec = (Td % 2 == 0 and I % 2 == 0 and S.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library()
    for c0 in range(0, len(comps), KT_MAX_COMPS):
        chunk = comps[c0:c0 + KT_MAX_COMPS]
        plan = kt_plan(K, O, I, ns, len(chunk), Td, vec, _sms(x.device), P)
        idx = (ctypes.c_int * len(chunk))(*chunk)
        build.check(lib.ke_trailing_apply_f64(
            S.data_ptr(), x.data_ptr(), out.data_ptr(), ctypes.addressof(idx), len(chunk), K,
            O, I, Td, ns, P, int(accumulate), plan.MT, plan.V, plan.NW, plan.nct, plan.nrt,
            stream), 'trailing_apply')
        build.count(trailing_apply, 'signed' if ns == 2 else x.dtype)
    return out


trailing_apply.launches = trailing_apply.launches_c128 = trailing_apply.launches_signed = 0
