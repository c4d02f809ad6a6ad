"""The port's config registry against the reference's, for all ten
architectures: every field of each full and smoke config
(``dataclasses.asdict``; ``decode_kernel`` through the value map
``DECODE_KERNEL_MAP``), the layer pattern and block structure, ``param_count``,
``config_for_shape`` for every (arch, shape) pair
with the long_500k skip and the sliding-window variants, the input
shapes; ``bridge.reference_shapes`` against the reference's
``tree_leaves`` of the smoke configs; and which paths each family
runs on (``check_ported`` / ``check_paged_ported``)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.models import init_model as jax_init
from repro_torch import configs
from repro_torch.bridge import reference_shapes
from repro_torch.models import (check_paged_ported, check_slab_ported,
                                check_train_ported)

ARCHS = sorted(jax_configs.ARCHITECTURES)
NEW = ["granite-20b", "qwen2.5-32b", "deepseek-coder-33b",
       "deepseek-moe-16b", "llava-next-mistral-7b", "seamless-m4t-large-v2"]


# the port's decode_kernel values -> the reference's: the kernel
# ("cuda" / "pallas") and the plain version ("plain" / "xla"); "auto",
# the port's default, is the device's rule and has no reference name (the
# reference's default is "xla", which is what "auto" runs on the CPU)
DECODE_KERNEL_MAP = {"cuda": "pallas", "plain": "xla"}
DEFAULTS = ("auto", "xla")


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("decode_kernel")
    return out


def _decode_kernel_maps(tcfg, jcfg):
    """The field's defaults, and each port value beside the reference's
    value the map gives it; the reference's names are refused."""
    assert (tcfg.decode_kernel, jcfg.decode_kernel) == DEFAULTS
    for port, ref in DECODE_KERNEL_MAP.items():
        assert tcfg.with_overrides(decode_kernel=port).decode_kernel == port
        assert jcfg.with_overrides(decode_kernel=ref).decode_kernel == ref
        with pytest.raises(ValueError, match=f'"{port}"'):
            tcfg.with_overrides(decode_kernel=ref)


def test_registry_holds_every_reference_architecture():
    assert sorted(configs.ARCHITECTURES) == ARCHS
    assert set(NEW) <= set(configs.ARCHITECTURES)
    assert configs.LONG_500K_SKIPS == jax_configs.LONG_500K_SKIPS
    assert configs.SWA_FOR_LONG == jax_configs.SWA_FOR_LONG
    assert configs.SWA_WINDOW == jax_configs.SWA_WINDOW
    assert ({k: dataclasses.asdict(v) for k, v in
             configs.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in
                jax_configs.INPUT_SHAPES.items()})
    assert configs.ONE_CARD_LAYERS == {"jamba-v0.1-52b": 8,
                                       "deepseek-v3-671b": 4}


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_reference(arch, which):
    get = {"full": (configs.get_config, jax_configs.get_config),
           "smoke": (configs.smoke_config, jax_configs.smoke_config)}[which]
    tcfg, jcfg = (f(arch) for f in get)
    assert _fields(tcfg) == _fields(jcfg)
    _decode_kernel_maps(tcfg, jcfg)
    assert tcfg.layer_pattern() == jcfg.layer_pattern()
    assert tcfg.block_structure() == jcfg.block_structure()
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("shape", sorted(jax_configs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_config_for_shape_equals_reference(arch, shape):
    try:
        want = jax_configs.config_for_shape(arch, shape)
    except ValueError as e:
        with pytest.raises(ValueError, match="long_500k"):
            configs.config_for_shape(arch, shape)
        assert (arch, shape) == ("seamless-m4t-large-v2", "long_500k"), e
        return
    got = configs.config_for_shape(arch, shape)
    assert _fields(got) == _fields(want)
    if shape == "long_500k" and arch in configs.SWA_FOR_LONG:
        assert got.swa_window == configs.SWA_WINDOW


@pytest.mark.parametrize("arch", NEW)
def test_reference_shapes_follow_tree_leaves(arch):
    """The flat master order of a ZeRO state and of a checkpoint:
    ``reference_shapes`` lists the reference's leaves by path, in its
    flatten order, with their shapes (the encoder stacked on its own
    depth)."""
    jcfg = jax_configs.smoke_config(arch).with_overrides(dtype="float32")
    params = jax.eval_shape(lambda: jax_init(jcfg, jax.random.PRNGKey(0)))
    want = [("/".join(str(getattr(k, "key", k)) for k in path), leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)]
    got = reference_shapes(configs.smoke_config(arch).with_overrides(
        dtype="float32"))
    assert list(got.items()) == want


@pytest.mark.parametrize("arch", NEW)
def test_each_family_runs_where_the_reference_runs_it(arch):
    """Every path takes the decoder-only newcomers; the slab and train
    paths take the VLM and the encoder-decoder, the paged pool refuses
    them as the reference's continuous batching does."""
    cfg = configs.get_config(arch)
    check_slab_ported(cfg)
    check_train_ported(cfg)
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        with pytest.raises(ValueError, match="decoder-only"):
            check_paged_ported(cfg)
    else:
        check_paged_ported(cfg)


def test_param_counts_of_the_newcomers():
    """The sizes this slice serves at full depth on one 80 GB card in
    bf16 (the reference's formula; the vision projector is not in it)."""
    got = {a: configs.get_config(a).param_count() for a in NEW}
    assert got == {a: jax_configs.get_config(a).param_count() for a in NEW}
    assert all(2 * n < 80e9 for n in got.values())
    assert np.isclose(got["qwen2.5-32b"] / 1e9, 32.76, atol=0.01)
    assert np.isclose(got["seamless-m4t-large-v2"] / 1e9, 2.03, atol=0.01)
