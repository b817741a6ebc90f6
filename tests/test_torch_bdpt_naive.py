"""BDPT's s=0 family of the PyTorch port, unweighted, is the naive path
tracer (tests/test_integrators.py's ``test_naive_depth6_vs_bdpt_s0``, on
the port): the same measurement function, paid at the first emissive hit,
built by two different code paths (``bdpt._walk`` and
``naive.trace_sample``). Naive lt_max_depth K walks surface vertices 1..K-1
and BDPT s=0 at bdpt_max_path_length K-1 pays t=2..K. On the test's open
diffuse box (flat quads: Ng = Ns) the means agree within 8 % and the
depth > 1 residuals (deep minus direct-only) within 15 %, at its 384 spp
and seeds.
"""
from test_torch_bdpt_integrators import _np, _scene
from tuturenderer_tpu_torch.integrators.bdpt import render as rb
from tuturenderer_tpu_torch.integrators.naive import render as rn
from tuturenderer_tpu_torch.options import RenderOptions


def test_naive_depth6_vs_bdpt_s0():
    scene, cam = _scene()
    spp = 384

    def naive_mean(k, seed):
        return _np(rn(scene, cam, RenderOptions(spp=spp, lt_max_depth=k),
                      seed)).mean()

    def bdpt_s0_mean(max_len, seed):
        return _np(rb(scene, cam, RenderOptions(
            spp=spp, bdpt_max_path_length=max_len, bdpt_s_filter=0,
            bdpt_unweighted=True, tutu_bdpt_weight_kill=False,
            tutu_bdpt_t1_gate=False, samples_per_launch=32), seed)).mean()

    nv_deep, nv_direct = naive_mean(6, 21), naive_mean(2, 21)
    bd_deep, bd_direct = bdpt_s0_mean(5, 22), bdpt_s0_mean(1, 22)
    rel_total = abs(nv_deep - bd_deep) / nv_deep
    assert rel_total < 0.08, \
        f"naive={nv_deep:.4f} bdpt_s0={bd_deep:.4f} rel={rel_total:.3f}"
    ind_nv = nv_deep - nv_direct
    ind_bd = bd_deep - bd_direct
    assert ind_nv > 0.0 and ind_bd > 0.0
    rel_ind = abs(ind_nv - ind_bd) / ind_nv
    assert rel_ind < 0.15, \
        f"indirect naive={ind_nv:.4f} bdpt_s0={ind_bd:.4f} rel={rel_ind:.3f}"
