"""The port's analytic core against the JAX package's: Table 1
(``core/hwspec.py``), the Figure 5-6 carbon model (``core/cci.py``) and the
three-term roofline (``core/roofline.py`` over ``core/hlo_analysis.py``'s
two cost records). Both packages get the same inputs; every table and
result must be equal, not close. The paper claims that ``tests/test_core.py``
checks on the reference are checked on the port too."""

import dataclasses
import math

import pytest

from repro.core import cci as ref_cci
from repro.core import hlo_analysis as ref_hlo
from repro.core import hwspec as ref_hw
from repro.core import roofline as ref_roof
from repro_torch.core import cci, hlo_analysis, hwspec, roofline

NAMES = sorted(ref_hw.BY_NAME)
SPEC_PROPS = ("peak_tflops", "torus_dims", "pod_bisection_gbps",
              "pod_peak_bf16_exaflops", "pod_peak_fp8_exaflops",
              "pod_hbm_gib", "pod_hbm_table_units", "hosts_per_pod")


def same(a, b):
    """Exact equality that also holds for NaN fields (TPU v5e's relative
    rows): ``repr`` of a float round-trips its bits."""
    return repr(a) == repr(b)


# ------------------------------------------------------------- hwspec


def test_generation_order_and_names_match():
    assert [s.name for s in hwspec.GENERATIONS] == \
        [s.name for s in ref_hw.GENERATIONS]
    assert sorted(hwspec.BY_NAME) == NAMES
    assert hwspec.TPU_V2_CHIP_TDP_W == ref_hw.TPU_V2_CHIP_TDP_W
    assert hwspec.TPU_V2_POD_TDP_W == ref_hw.TPU_V2_POD_TDP_W


@pytest.mark.parametrize("name", NAMES)
def test_table1_column_matches(name):
    got, want = hwspec.get(name), ref_hw.get(name)
    assert same(dataclasses.asdict(got), dataclasses.asdict(want))
    for prop in SPEC_PROPS:
        assert same(getattr(got, prop), getattr(want, prop)), prop
    for dt in ("bf16", "fp8"):
        assert got.matmul_peak_flops_per_cycle(dt) == \
            want.matmul_peak_flops_per_cycle(dt)
    assert same(hwspec.pod_tdp_watts(got), ref_hw.pod_tdp_watts(want))
    assert same(hwspec.chip_tdp_watts(got), ref_hw.chip_tdp_watts(want))
    assert dataclasses.asdict(hwspec.roofline_target_for(got)) == \
        dataclasses.asdict(ref_hw.roofline_target_for(want))


def test_unknown_generation_raises_the_same_error():
    with pytest.raises(KeyError) as got:
        hwspec.get("tpu_v9")
    with pytest.raises(KeyError) as want:
        ref_hw.get("tpu_v9")
    assert str(got.value) == str(want.value)


def test_scaling_summary_and_roofline_target_match():
    assert hwspec.scaling_summary() == ref_hw.scaling_summary()
    assert dataclasses.asdict(hwspec.ROOFLINE_TARGET) == \
        dataclasses.asdict(ref_hw.ROOFLINE_TARGET)


def test_table1_bisection_matches_paper():
    claims = {"tpu_v2": 1984, "tpu_v3": 4480, "tpu_v4": 25600,
              "tpu_v5p": 64000, "ironwood": 76800}
    for spec in hwspec.GENERATIONS:
        assert spec.pod_bisection_gbps == pytest.approx(
            claims[spec.name], rel=1e-3), spec.name


def test_scaling_headlines():
    s = hwspec.scaling_summary()
    assert s["pod_size_x"] == 36.0
    assert 3500 < s["pod_peak_x"] < 3700  # "~3600x"
    assert 95 < s["node_peak_x"] < 105  # "~100x"
    assert 400 < s["pod_hbm_x"] < 450  # "~400x"


def test_mxu_flops_consistency():
    v4 = hwspec.TPU_V4
    assert v4.matmul_peak_flops_per_cycle() == 8 * 2 * 128 * 128
    iw = hwspec.IRONWOOD
    assert iw.matmul_peak_flops_per_cycle("fp8") == \
        4 * iw.matmul_peak_flops_per_cycle("bf16")
    assert iw.peak_fp8_tflops == 2 * iw.peak_bf16_tflops


# ---------------------------------------------------------------- cci


def test_cci_table_matches():
    assert [dataclasses.asdict(r) for r in cci.CCI_TABLE] == \
        [dataclasses.asdict(r) for r in ref_cci.CCI_TABLE]
    for r, w in zip(cci.CCI_TABLE, ref_cci.CCI_TABLE):
        for prop in ("total_market", "total_location",
                     "embodied_share_market", "embodied_share_location"):
            assert getattr(r, prop) == getattr(w, prop), prop
    assert sorted(cci.CCI_BY_NAME) == sorted(ref_cci.CCI_BY_NAME)
    assert cci.perf_per_watt_relative() == ref_cci.perf_per_watt_relative()


@pytest.mark.parametrize("flops", [0.0, 1.0, 1e18, 3.14e23, 7.5e25])
@pytest.mark.parametrize("market", [True, False])
def test_emissions_match(flops, market):
    for r, w in zip(cci.CCI_TABLE, ref_cci.CCI_TABLE):
        assert cci.emissions_grams(flops, r, market=market) == \
            ref_cci.emissions_grams(flops, w, market=market)


@pytest.mark.parametrize("eef,fpw", [(100.0, 1e12), (475.0, 3.3e11),
                                     (0.0, 1e10), (12.5, 7.7e13)])
def test_operational_cci_identity_matches(eef, fpw):
    assert cci.operational_cci_from_perf_per_watt(eef, fpw) == \
        ref_cci.operational_cci_from_perf_per_watt(eef, fpw)


def test_carbon_ledger_matches():
    led, ref = (cci.CarbonLedger(cci.CCI_IRONWOOD),
                ref_cci.CarbonLedger(ref_cci.CCI_IRONWOOD))
    for f in (1e18, 2.5e17, 0.0, 6 * 494e6 * 8192):
        led.record_step(f)
        ref.record_step(f)
    assert led.summary() == ref.summary()
    assert led.grams_co2e == ref.grams_co2e
    with pytest.raises(ValueError):
        led.record_step(-1.0)


def test_cci_paper_relations():
    v4, v5p, iw = cci.CCI_TPU_V4, cci.CCI_TPU_V5P, cci.CCI_IRONWOOD
    assert v5p.total_market == pytest.approx(265, rel=0.02)
    assert v4.operational_market / v5p.operational_market == \
        pytest.approx(1.1, rel=0.05)
    assert v4.embodied / v5p.embodied == pytest.approx(1.3, rel=0.05)
    assert v5p.operational_market / iw.operational_market == \
        pytest.approx(3.7, rel=0.05)
    assert iw.embodied_share_location == pytest.approx(0.08, rel=0.15)
    assert cci.emissions_grams(3.14e23, v5p) == pytest.approx(8.3e7,
                                                              rel=0.05)
    assert cci.operational_cci_from_perf_per_watt(
        electricity_gco2e_per_kwh=100.0, flops_per_watt=1e12) == \
        pytest.approx(27.8, rel=0.01)


# ----------------------------------------------------------- roofline


def test_cost_records_have_the_reference_fields():
    for mine, ref in ((hlo_analysis.CollectiveRecord,
                       ref_hlo.CollectiveRecord),
                      (hlo_analysis.HloCostReport, ref_hlo.HloCostReport)):
        assert [(f.name, f.type) for f in dataclasses.fields(mine)] == \
            [(f.name, f.type) for f in dataclasses.fields(ref)]


def _report(mod, hw, *, n, tokens, chips, target, mesh, axes, **kw):
    cost = mod.synthetic_train_cost(n_params_active=n, tokens_global=tokens,
                                    chips=chips, **kw)
    t = hw.roofline_target_for(hw.get(target)) if target else \
        hw.ROOFLINE_TARGET
    return cost, mod.build_report(
        arch="synthetic", shape=f"{n:.0e}x{tokens:.0e}", mesh_shape=mesh,
        axis_names=axes, cost=cost,
        model_flops_global=mod.model_flops(n, tokens, True), target=t)


ROOF_CASES = [
    (70e9, 4096 * 4096, 2048, "ironwood", (2048,), ("data",), {}),
    (70e9, 4096 * 4096, 256, "tpu_v4", (256,), ("data",), {}),
    (8e9, 1024 * 1024, 192, "tpu_v4", (192,), ("data",), {}),
    (8e9, 1024 * 1024, 1, "tpu_v2", (1,), ("data",), {}),
    (494e6, 4 * 2048, 64, None, (4, 16), ("pod", "data"), {}),
    (1e9, 65536, 512, "tpu_v5p", (512,), ("data",),
     dict(param_bytes=4.0, traversals=2.0, opt_state_bytes=12.0)),
]


@pytest.mark.parametrize("case", ROOF_CASES,
                         ids=[f"{c[3]}-{c[2]}" for c in ROOF_CASES])
def test_synthetic_roofline_report_matches(case):
    n, tokens, chips, target, mesh, axes, kw = case
    got_cost, got = _report(roofline, hwspec, n=n, tokens=tokens,
                            chips=chips, target=target, mesh=mesh,
                            axes=axes, **kw)
    want_cost, want = _report(ref_roof, ref_hw, n=n, tokens=tokens,
                              chips=chips, target=target, mesh=mesh,
                              axes=axes, **kw)
    assert dataclasses.asdict(got_cost) == dataclasses.asdict(want_cost)
    assert got_cost.collective_bytes() == want_cost.collective_bytes()
    assert got_cost.collective_bytes_by_axes() == \
        want_cost.collective_bytes_by_axes()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    for prop in ("bound", "t_bound", "t_serial", "useful_flops_ratio",
                 "roofline_fraction", "fits_hbm"):
        assert getattr(got, prop) == getattr(want, prop), prop


OPCODES = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "ragged-all-to-all", "collective-permute", "send"]


@pytest.mark.parametrize("opcode", OPCODES)
@pytest.mark.parametrize("axes,group", [(("data",), 16), (("pod",), 4),
                                        (("data", "pod"), 64), (("?",), 8),
                                        (("data",), 1)])
def test_collective_time_matches(opcode, axes, group):
    def one(mod, hlo, hw):
        rec = hlo.CollectiveRecord(
            opcode=opcode, comp="c", result_bytes=3.5e8,
            operand_bytes=1.25e8, group_size=group, groups=(),
            multiplier=2.0, axes=axes)
        links = mod.mesh_axis_links((16, 4), ("data", "pod"),
                                    hw.roofline_target_for(hw.TPU_V4),
                                    pod_bw_fraction=0.1)
        return mod.collective_time(rec, links), \
            {k: dataclasses.asdict(v) for k, v in links.items()}
    assert one(roofline, hlo_analysis, hwspec) == \
        one(ref_roof, ref_hlo, ref_hw)


def test_model_flops_and_guards_match():
    for n, d, train in ((70e9, 1e6, True), (494e6, 8192, False),
                        (0.0, 1.0, True)):
        assert roofline.model_flops(n, d, train) == \
            ref_roof.model_flops(n, d, train)
    with pytest.raises(ValueError):
        roofline.synthetic_train_cost(n_params_active=1e9,
                                      tokens_global=1e6, chips=0)
    rep = _report(roofline, hwspec, n=1e9, tokens=1e6, chips=8,
                  target="tpu_v4", mesh=(8,), axes=("data",))[1]
    assert math.isfinite(rep.t_bound) and rep.t_bound > 0
