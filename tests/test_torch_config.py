"""The port's configuration tree equals the JAX package's, field for field."""

import dataclasses

from physimglobalpose_tpu import config as jcfg
from physimglobalpose_tpu_torch import config as tcfg


def test_default_trees_equal():
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(jcfg.PipelineConfig())
    assert dataclasses.asdict(tcfg.DEFAULT_CONFIG) == dataclasses.asdict(jcfg.DEFAULT_CONFIG)


def test_field_names_and_types_equal():
    def walk(a, b):
        fa, fb = dataclasses.fields(a), dataclasses.fields(b)
        assert [(f.name, f.type) for f in fa] == [(f.name, f.type) for f in fb]
        for f in fa:
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(va):
                walk(va, vb)

    walk(tcfg.PipelineConfig(), jcfg.PipelineConfig())
