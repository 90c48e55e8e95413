"""The port's last tools (``tools_torch/preset_bench.py`` and
``tools_torch/ablation/{headline_probe, fused_stage_ablation,
gather_ablation, u8_writeback_ab}.py``) against the JAX package's, on the
CPU: what they run is read from both sides and held equal.

- The K1 knockout modes carry the JAX tool's names, in its order; each of
  the JAX gather tool's modes has a K2 knockout or a stated reason.
- Each knockout macro a mode names is tested under ``#if defined(...)`` in
  ``fsr_tpu_torch/csrc`` beside the ablation mask (so a build with it
  changes a kernel), and the mask sets the bit that
  ``_build.ABLATION_MACROS`` gives it; the production flags define none,
  and a library whose mask is not the one asked for is refused (a
  misspelt ``-D`` builds the production kernel).
- preset_bench's sizes are the JAX tool's (read with ``ast``: that script
  runs at import).
- The torch narrowing of 10-bit codes equals the JAX tool's ``jnp``
  formula on all 1024 codes, and ``encode_unorm8`` equals JAX's on the same
  floats, bit for bit.
- Each tool's ``main()`` exits non-zero with a message when there is no
  CUDA device (the kernels, and so the tools, run only on the card).
"""

from __future__ import annotations

import ast
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.kernels import epilogue as jepilogue
from fsr_tpu_torch.kernels import _build
from fsr_tpu_torch.kernels.epilogue import encode_unorm8
from tools_torch import preset_bench
from tools_torch.ablation import fused_stage_ablation, gather_ablation, headline_probe, u8_writeback_ab

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "fsr_tpu_torch" / "csrc"


def _jax_tool(rel):
    """A JAX tool module loaded by path (``tools/`` is no package; the
    ablation tools import only os, subprocess and sys at the top)."""
    spec = importlib.util.spec_from_file_location("jax_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sources() -> str:
    return "\n".join(p.read_text() for p in sorted(CSRC.iterdir()) if p.suffix in (".cu", ".cuh"))


def test_k1_modes_are_the_jax_tools():
    jax_modes = [m for m, _ in _jax_tool("tools/ablation/fused_stage_ablation.py").MODES]
    assert [m[0] for m in fused_stage_ablation.MODES] == jax_modes
    # Every mode but the baseline and norcas (apply_rcas=False) is a build.
    assert [m[0] for m in fused_stage_ablation.MODES if m[2] is None] == ["", "norcas"]


def test_gather_modes_have_a_macro_or_a_reason():
    jax_modes = [m for m, _ in _jax_tool("tools/ablation/gather_ablation.py").MODES]
    ours = {m[0]: m[2] for m in gather_ablation.MODES}
    for mode in jax_modes:
        assert (mode in ours) != (mode in gather_ablation.NO_COUNTERPART), mode
        if mode in gather_ablation.NO_COUNTERPART:
            assert len(gather_ablation.NO_COUNTERPART[mode]) > 20, mode
    assert ours["nog"] == "FSR_ABL_K2_NOG"
    assert ours[""] is None and ours["norcas"] is None


def _mode_macros():
    return sorted({m[2] for m in fused_stage_ablation.MODES + gather_ablation.MODES if m[2]})


def test_every_macro_has_a_mask_bit_and_a_knockout():
    assert _mode_macros() == sorted(_build.ABLATION_MACROS)
    src = _sources()
    block = re.search(r"constexpr int ABLATION_MASK = 0(.*?);", src, re.S).group(1)
    bits = {m: int(k) for m, k in re.findall(r"#if defined\((\w+)\)\s*\|\s*1 << (\d+)", block)}
    assert bits == {m: k for k, m in enumerate(_build.ABLATION_MACROS)}
    outside = src.replace(block, "")
    for macro in _build.ABLATION_MACROS:
        assert re.search(rf"#\s*(?:el)?if\s+defined\({macro}\)|#\s*ifdef\s+{macro}\b", outside), macro
    assert re.search(r'extern "C" int fsr_ablation_mask\(void\) \{ return ABLATION_MASK; \}', src)


def test_production_flags_define_no_knockout():
    assert not any("FSR_ABL" in f for f in _build.NVCC_FLAGS)


class _FakeLib:
    """A stand-in for a built library: its ``fsr_ablation_mask()``."""

    def __init__(self, mask):
        self.fsr_ablation_mask = lambda: mask


def test_mask_check_refuses_a_library_built_otherwise():
    k = _build.ABLATION_MACROS.index("FSR_ABL_K1_POLY")
    assert _build.ablation_mask(_FakeLib(1 << k)) == {"FSR_ABL_K1_POLY"}
    fused_stage_ablation.check_mask(_FakeLib(1 << k), "FSR_ABL_K1_POLY")
    fused_stage_ablation.check_mask(_FakeLib(0), None)
    # A misspelt -D sets no bit: the production kernel, refused.
    with pytest.raises(RuntimeError, match="FSR_ABL_K1_POLY"):
        fused_stage_ablation.check_mask(_FakeLib(0), "FSR_ABL_K1_POLY")
    with pytest.raises(RuntimeError):
        fused_stage_ablation.check_mask(_FakeLib(1 << k), None)


def test_preset_sizes_are_the_jax_tools():
    tree = ast.parse((ROOT / "tools" / "preset_bench.py").read_text())
    presets = next(ast.literal_eval(node.value) for node in ast.walk(tree) if isinstance(node, ast.Assign)
                   and any(isinstance(t, ast.Name) and t.id == "presets" for t in node.targets))
    assert preset_bench.PRESETS == presets
    assert gather_ablation.SIZES == {"1.3": presets["ultra_quality_1.3x"], "1.7": presets["balanced_1.7x"]}


def test_narrowing_equals_the_jax_formula():
    codes = np.arange(1024, dtype=np.uint16)
    c = jnp.asarray(codes)
    want = np.asarray((c.astype(jnp.uint32) * 255 * 2 + 1023).__floordiv__(2046).astype(jnp.uint8))
    got = u8_writeback_ab.narrow(torch.from_numpy(codes)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_encode_unorm8_equals_jax():
    rng = np.random.default_rng(3)
    k = np.arange(256, dtype=np.float64)
    edges = ((k + 0.5) / 255).astype(np.float32)  # the round's knife edges, and an ulp either side
    x = np.concatenate([
        rng.uniform(-0.25, 1.25, 20000).astype(np.float32),
        edges, np.nextafter(edges, np.float32(0)), np.nextafter(edges, np.float32(2)),
        (k / 255).astype(np.float32),
        np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 2.0, -1.0], np.float32),
        # bfloat16 values, as the bf16_out+encode route encodes them.
        torch.from_numpy(rng.uniform(0, 1, 5000).astype(np.float32)).to(torch.bfloat16).float().numpy(),
    ])
    got = encode_unorm8(torch.from_numpy(x)).numpy()
    want = np.asarray(jepilogue.encode_unorm8(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tool", [preset_bench, headline_probe, fused_stage_ablation, gather_ablation,
                                  u8_writeback_ab], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = tool.main([]) if tool is gather_ablation else tool.main()
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_gather_ablation_refuses_an_unknown_preset(capsys):
    assert gather_ablation.main(["1.5"]) == 2
    assert "preset must be one of" in capsys.readouterr().err
