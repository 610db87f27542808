"""The port's config registry against the JAX package's: every arch's
config and smoke variant field for field, the analytic parameter
counts, the input shapes and the shape adaptation."""
import dataclasses

import pytest

pytest.importorskip("jax")

import repro.configs as jcfg  # noqa: E402
import repro.configs.base as jbase  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.configs.base as tbase  # noqa: E402


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_arch_ids_equal_reference():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert len(tcfg.ARCH_IDS) == 10


def test_model_config_fields_and_defaults_equal_reference():
    tf = {f.name: f.default for f in dataclasses.fields(tbase.ModelConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(jbase.ModelConfig)}
    assert tf == jf
    assert _fields(tbase.ModelConfig()) == _fields(jbase.ModelConfig())


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(arch, smoke):
    t = tcfg.get_config(arch, smoke=smoke)
    j = jcfg.get_config(arch, smoke=smoke)
    assert _fields(t) == _fields(j)
    assert t.param_count() == j.param_count()
    assert t.param_count(active_only=True) == j.param_count(
        active_only=True)
    assert t.active_param_count() == j.active_param_count()
    assert (t.q_per_kv, t.d_inner, t.ssm_heads) == (j.q_per_kv, j.d_inner,
                                                    j.ssm_heads)


@pytest.mark.parametrize("shape", sorted(jbase.SHAPES))
def test_shapes_and_adaptation_equal_reference(shape):
    ts, js = tbase.SHAPES[shape], jbase.SHAPES[shape]
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for arch in jcfg.ARCH_IDS:
        t = tcfg.get_config(arch, shape=ts)
        j = jcfg.get_config(arch, shape=js)
        assert _fields(t) == _fields(j)
        assert _fields(tcfg.adapt_for_shape(tcfg.get_config(arch), ts)) == \
            _fields(jcfg.adapt_for_shape(jcfg.get_config(arch), js))
        assert _fields(tcfg.get_config(arch, smoke=True, shape=ts)) == \
            _fields(jcfg.get_config(arch, smoke=True, shape=js))


def test_all_configs_and_smoke_variant_equal_reference():
    for smoke in (False, True):
        t, j = tcfg.all_configs(smoke), jcfg.all_configs(smoke)
        assert list(t) == list(j)
        assert all(_fields(t[a]) == _fields(j[a]) for a in j)
    cfg = dict(arch_id="x", n_heads=12, n_kv_heads=6, d_model=768,
               attention_window=4096, xlstm_pattern="msms", n_experts=8)
    assert _fields(tbase.smoke_variant(tbase.ModelConfig(**cfg))) == \
        _fields(jbase.smoke_variant(jbase.ModelConfig(**cfg)))


def test_bad_configs_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("gpt-5")
    # the reference asserts; the port raises a ValueError
    with pytest.raises(ValueError, match="not divisible"):
        tbase.ModelConfig(arch_id="bad", n_heads=6, n_kv_heads=4)
