"""Kernel registry of the port (``paddle_tpu_torch.ops.registry``), held to
the cases of ``tests/test_kernel_registry.py``: ordered implementations with
availability predicates, per-signature selection caching (shape, dtype and
device type), ``kernels.<k>.*`` counters, watched-flag cache keys and the
``FLAGS_kernel_overrides`` escape hatch."""
import pytest
import torch

from paddle_tpu_torch.framework.flags import _REGISTRY as _FLAGS
from paddle_tpu_torch.framework.flags import get_flags, set_flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.ops import registry


@pytest.fixture(autouse=True)
def _clean_registry_state():
    registry.clear_cache()
    _metrics.reset_counters("kernels.")
    saved_overrides = _FLAGS["FLAGS_kernel_overrides"]
    yield
    _FLAGS["FLAGS_kernel_overrides"] = saved_overrides
    registry.clear_cache()


def _fresh_kernel(name, flags=()):
    registry._KERNELS.pop(name, None)
    return registry.define_kernel(name, flags=flags)


def test_registry_first_available_wins_and_counts():
    _fresh_kernel("_t_sel")
    calls = []
    registry.register("_t_sel", "never", lambda x: "never",
                      available=lambda x: calls.append("never") or False)
    registry.register("_t_sel", "big_only", lambda x: "big",
                      available=lambda x: calls.append("big") or x.shape[0] >= 8)
    registry.register("_t_sel", "xla", lambda x: "fallback", fallback=True)

    big, small = torch.zeros((8, 4)), torch.zeros((2, 4))
    assert registry.dispatch("_t_sel", big) == "big"
    assert registry.dispatch("_t_sel", small) == "fallback"
    counts = _metrics.counters("kernels._t_sel.")
    assert counts["kernels._t_sel.picked"] == 1
    assert counts["kernels._t_sel.fallback"] == 1


def test_registry_selection_cached_per_signature():
    _fresh_kernel("_t_cache")
    probes = []
    registry.register("_t_cache", "k", lambda x: "k",
                      available=lambda x: probes.append(tuple(x.shape)) or True)
    registry.register("_t_cache", "xla", lambda x: "f", fallback=True)

    a = torch.zeros((4, 4))
    for _ in range(5):
        registry.dispatch("_t_cache", a)
    assert len(probes) == 1  # predicate ran once; 4 cache hits
    registry.dispatch("_t_cache", torch.zeros((2, 4)))  # new shape: re-selects
    assert len(probes) == 2
    registry.dispatch("_t_cache", torch.zeros((4, 4), dtype=torch.bfloat16))  # new dtype
    assert len(probes) == 3
    registry.dispatch("_t_cache", torch.zeros((4, 4), device="meta"))  # new device type
    assert len(probes) == 4
    assert _metrics.counters("kernels._t_cache.")["kernels._t_cache.picked"] == 4


def test_registry_fallback_sorts_last_regardless_of_order():
    _fresh_kernel("_t_order")
    registry.register("_t_order", "xla", lambda x: "f", fallback=True)
    registry.register("_t_order", "kern", lambda x: "k", available=lambda x: True)
    assert registry.implementations("_t_order") == ["kern", "xla"]
    assert registry.dispatch("_t_order", torch.zeros(3)) == "k"


def test_registry_overrides_force_and_unknown_raises():
    _fresh_kernel("_t_force")
    registry.register("_t_force", "kern", lambda x: "k", available=lambda x: True)
    registry.register("_t_force", "xla", lambda x: "f", fallback=True)

    _FLAGS["FLAGS_kernel_overrides"] = "_t_force=xla"
    assert registry.dispatch("_t_force", torch.zeros(3)) == "f"  # bypasses kern
    _FLAGS["FLAGS_kernel_overrides"] = "_t_force=nope"
    with pytest.raises(KeyError, match="nope"):
        registry.dispatch("_t_force", torch.zeros(3))
    # the override value is part of the cache key: clearing it re-selects
    _FLAGS["FLAGS_kernel_overrides"] = ""
    assert registry.dispatch("_t_force", torch.zeros(3)) == "k"


def test_registry_watched_flag_invalidate():
    _fresh_kernel("_t_flag", flags=("FLAGS_use_flash_attention",))
    registry.register("_t_flag", "kern", lambda x: "k",
                      available=lambda x: bool(_FLAGS["FLAGS_use_flash_attention"]))
    registry.register("_t_flag", "xla", lambda x: "f", fallback=True)

    saved = get_flags("FLAGS_use_flash_attention")
    try:
        set_flags({"FLAGS_use_flash_attention": True})
        assert registry.dispatch("_t_flag", torch.zeros(3)) == "k"
        set_flags({"FLAGS_use_flash_attention": False})  # no explicit invalidation
        assert registry.dispatch("_t_flag", torch.zeros(3)) == "f"
    finally:
        set_flags(saved)


def test_kernel_table_lists_builtin_kernels():
    by_kernel = {}
    for r in registry.kernel_table():
        by_kernel.setdefault(r["kernel"], []).append(r)
    # the reference's order: the flat kernels' impls (K3/K3b, behind
    # FLAGS_flash_flat) after flash in sdpa, before it in attention_core
    impls = {"sdpa": ["flash", "flash_flat_gqa", "xla"],
             "attention_core": ["flash_packed", "flash", "xla"]}
    for name, want in impls.items():
        assert name in by_kernel, f"{name} not registered"
        assert [r["impl"] for r in by_kernel[name]] == want
        assert by_kernel[name][-1]["fallback"], f"{name} has no fallback"


@pytest.mark.parametrize("head_dim, impl", [(64, "flash"), (128, "flash"), (32, "xla")])
def test_sdpa_selects_flash_where_the_kernel_takes_the_call(head_dim, impl):
    """``sdpa`` picks ``flash`` for the kernel's head dims (on a CPU tensor
    flash runs its plain version) and the ``xla`` fallback elsewhere; both
    agree with the composite."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 32, 2, head_dim), generator=g) for _ in range(3))
    assert registry.select("sdpa", q, k, v, None, True, 0.0, None).name == impl
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    torch.testing.assert_close(out, F.attention._sdpa_reference(q, k, v, None, True),
                               atol=1e-6, rtol=1e-5)
    mask = torch.ones((32, 32), dtype=torch.bool)
    assert registry.select("sdpa", q, k, v, mask, True, 0.0, None).name == "xla"
