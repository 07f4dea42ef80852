"""The pencil system of the PyTorch port against dedalus_tpu: sampled
separable M/L stacks, index maps and validity, the banded order and plan,
the band blocks, and the structured gather/scatter (bit for bit against the
generic index map). RBC at 32x16 and at 64x12 (G=32, sampled path)."""

import numpy as np
import pytest
import torch

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig
from dedalus_tpu_torch.core import subsystems as tsub

SIZES = [(32, 16), (64, 12)]

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


@pytest.fixture(scope='module', params=SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def pencils(request):
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    Nx, Nz = request.param
    old = (jconfig.get('memory', 'max_dense_stack_gb'),
           jconfig.get('matrix assembly', 'sampled_min_groups'),
           tconfig.get('matrix assembly', 'sampled_min_groups'))
    jconfig.set('memory', 'max_dense_stack_gb', '0')
    jconfig.set('matrix assembly', 'sampled_min_groups', '8')
    tconfig.set('matrix assembly', 'sampled_min_groups', '8')
    try:
        jp, _ = jbuild(Nx, Nz, Rayleigh=1e5)
        tp, _ = tbuild(Nx, Nz, Rayleigh=1e5, device='cpu')
        js = jp.build_solver(jd3.SBDF2, matsolver='banded')
        ts = tp.build_solver(td3.SBDF2, matsolver='banded')
        yield js.pencil, ts.pencil
    finally:
        jconfig.set('memory', 'max_dense_stack_gb', old[0])
        jconfig.set('matrix assembly', 'sampled_min_groups', old[1])
        tconfig.set('matrix assembly', 'sampled_min_groups', old[2])


@pytest.mark.parametrize('name', ['M', 'L'])
def test_separable_stacks_equal(pencils, name):
    jp, tp = pencils
    assert tp.separable is not None and jp.separable is not None
    js, ts = jp.separable[name], tp.separable[name]
    assert ts.degree == js.degree
    np.testing.assert_array_equal(ts.ghat, js.ghat)
    np.testing.assert_array_equal(ts.weights(), js.weights())
    for Bt, Bj in zip(ts.B, js.B):
        np.testing.assert_array_equal(Bt.toarray(), Bj.toarray())
    assert sorted(ts.bad) == sorted(js.bad)
    for g in range(tp.G):
        np.testing.assert_array_equal(ts[g].toarray(), js[g].toarray())


def test_index_maps_and_validity_equal(pencils):
    jp, tp = pencils
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C)
    np.testing.assert_array_equal(tp.var_index_map, jp.var_index_map)
    for mt, mj in zip(tp.eq_index_maps, jp.eq_index_maps):
        np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(tp.row_valid, jp.row_valid)
    np.testing.assert_array_equal(tp.col_valid, jp.col_valid)
    for (rt, ct), (rj, cj) in zip(tp.pivot_pairs, jp.pivot_pairs):
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(ct, cj)


def test_banded_order_and_plan_equal(pencils):
    jp, tp = pencils
    pt, pj = tp.banded_plan(), jp.banded_plan()
    assert pt['nb'] == pj['nb']
    for key in ('col_perm', 'row_perm'):
        np.testing.assert_array_equal(pt['order'][key], pj['order'][key])
    for key in ('n_border', 'n_core', 'bcol_first'):
        assert pt['order'][key] == pj['order'][key]
    for (rt, ct), (rj, cj) in zip(tp.banded_pivot_pairs(pt['order']),
                                  jp.banded_pivot_pairs(pj['order'])):
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize('name', ['M', 'L'])
def test_band_blocks_equal(pencils, name):
    jp, tp = pencils
    bt, bj = tp.banded_stack(name), jp.banded_stack(name)
    assert (bt.G, bt.Nb, bt.nb, bt.pad, bt.nbord, bt.bcol0) == \
        (bj.G, bj.Nb, bj.nb, bj.pad, bj.nbord, bj.bcol0)
    for key in ('diag', 'sub', 'sup', 'Ucol', 'Vrow'):
        np.testing.assert_array_equal(getattr(bt, key), getattr(bj, key))


def test_structured_gather_matches_generic_bit_for_bit(pencils):
    jp, tp = pencils
    assert tp._gs_plan is not None
    rng = np.random.default_rng(1)
    flat = torch.as_tensor(rng.standard_normal(tp.state_total))
    got = tp.gather_state(flat)
    generic = (flat[torch.as_tensor(tp.var_index_map.astype(np.int64))]
               * torch.as_tensor(tp.col_valid.astype(np.float64)))
    assert torch.equal(got, generic)
    ref = np.asarray(jp.gather_state(flat.numpy()))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_structured_scatter_matches_generic_bit_for_bit(pencils):
    jp, tp = pencils
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.standard_normal((tp.G, tp.C)) * tp.col_valid)
    got = tp.scatter_state(X)
    generic = torch.zeros(tp.state_total, dtype=X.dtype).index_add_(
        0, torch.as_tensor(tp.var_index_map.reshape(-1).astype(np.int64)), X.reshape(-1))
    assert torch.equal(got, generic)
    ref = np.asarray(jp.scatter_state(X.numpy()))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_eq_gather_matches_generic(pencils):
    jp, tp = pencils
    rng = np.random.default_rng(4)
    datas = []
    for m in tp.eq_index_maps:
        datas.append(rng.standard_normal(int(m.max()) + 1))
    got = tp.gather_eq_data([torch.as_tensor(d) for d in datas])
    cols = [torch.as_tensor(d)[torch.as_tensor(m.astype(np.int64))]
            for d, m in zip(datas, tp.eq_index_maps)]
    generic = torch.cat(cols, dim=1) * torch.as_tensor(tp.row_valid.astype(np.float64))
    assert torch.equal(got, generic)
    ref = np.asarray(jp.gather_eq_data(datas))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gs_plan_rejects_non_affine_map():
    idx = np.array([[0, 5], [2, 3], [9, 1]], dtype=np.int32)
    assert tsub._build_gs_plan(idx, np.ones(idx.shape, bool), 10, 'cpu') is None
