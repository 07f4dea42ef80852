"""
Carrying state and factorizations over from dedalus_tpu, as numpy.

Both helpers take numpy inputs only (the caller converts the JAX package's
arrays with np.asarray), so this module never imports jax. The tests use
them to hand identical inputs and identical factors to both packages.
"""

import numpy as np
import torch


def set_state_from_reference(solver, arrays, fields=None, layout='c'):
    """Set the port's state fields from arrays keyed by field name (numpy,
    as dedalus_tpu's Field data at scale 1; in coefficient layout polar and
    sphere fields in their rectangular (m, slot) storage, ball and shell
    fields in their (m, ell slot, n) storage with regularity components,
    and the spin components of fields on a ball's or shell's surface;
    complex fields of the curvilinear bases in their signed (+m, -m) slot
    storage, the dead -0 slot included).
    `solver` is an IVP, LBVP, NLBVP or EVP solver, whose problem variables
    are set (an NLBVP's variables, not the perturbations its pencils solve
    for; an EVP's eigenvalue field too where `arrays` has its name);
    `fields` names other fields to set
    instead of its variables (the right-hand-side fields of an LBVP, the
    NCC fields of a problem such as the shell's er, ez and rvec or the
    ball's r_vec); `layout`
    is 'c' for coefficient data or 'g' for grid data."""
    if fields is None:
        fields = list(solver.problem.variables)
        eigenvalue = getattr(solver.problem, 'eigenvalue', None)
        if eigenvalue is not None and eigenvalue.name in arrays:
            fields.append(eigenvalue)
    for field in fields:
        field.change_scales(1)
        field[layout] = np.asarray(arrays[field.name])


def banded_arrays_from_reference(fac_np, device='cpu'):
    """A dedalus_tpu BorderedBandedSolver factorization (its
    `solve_arrays()` converted to numpy, raw scan-form factors, plus
    'bad_idx') -> the port's BorderedBandedSolver.arrs on `device`."""
    put = lambda a: torch.as_tensor(np.array(a), device=device)
    fac = {k: put(v) for k, v in fac_np['fac'].items()}
    if 'W1' in fac:     # in memory as (G, B, Pp), the way K6 post reads it
        fac['W1'] = fac['W1'].transpose(1, 2).contiguous().transpose(1, 2)
    col_unperm = put(fac_np['col_unperm']).long()
    arrs = dict(fac=fac, row_perm=put(fac_np['row_perm']).long(),
                col_unperm=col_unperm, col_perm=torch.argsort(col_unperm),
                Dr=put(fac_np['Dr']), Dc=put(fac_np['Dc']))
    bad_idx = tuple(int(g) for g in fac_np.get('bad_idx', ()))
    if bad_idx:
        arrs['Abad_inv'] = put(fac_np['Abad_inv'])
        arrs['bad_idx'] = torch.as_tensor(bad_idx, device=device)
    return arrs
