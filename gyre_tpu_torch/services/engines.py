"""EnginesService: engine listing with capability report.

Counterpart of gyre_tpu/services/engines.py. Reports only the samplers the
port runs, and no prompt artifacts (txt2img takes text prompts only).
"""

from __future__ import annotations

from gyre_tpu.generated import engines_pb2 as epb
from gyre_tpu.generated import generation_pb2 as gpb
from gyre_tpu.services.exception_to_grpc import exception_to_grpc

from ..pipeline.samplers import (PORTED_SAMPLERS, PROTO_SAMPLERS,
                                 SAMPLER_PROPERTIES)

_NOISE = {"normal": gpb.SAMPLER_NOISE_NORMAL,
          "brownian": gpb.SAMPLER_NOISE_BROWNIAN}


def _engine_samplers():
    out = []
    for value, name in PROTO_SAMPLERS.items():
        if name not in PORTED_SAMPLERS:
            continue
        props = SAMPLER_PROPERTIES[name]
        out.append(epb.EngineSampler(
            sampler=value,
            supports_eta=props["supports_eta"],
            supports_churn=props["supports_churn"],
            supports_sigma_limits=props["supports_sigma_limits"],
            supports_karras_rho=props["supports_karras_rho"],
            supported_noise_types=[_NOISE[n]
                                   for n in props["supported_noise_types"]],
        ))
    return out


class EnginesServiceServicer:
    def __init__(self, manager):
        self.manager = manager

    @exception_to_grpc()
    def ListEngines(self, request: epb.ListEnginesRequest, context):
        if request.task_group != epb.GENERATE:
            return epb.Engines(engine=[])
        engines = []
        for spec in self.manager.specs:
            if not spec.visible or spec.task != "generate":
                continue
            info = epb.EngineInfo(
                id=spec.id, name=spec.name, description=spec.description,
                owner="gyre-tpu",
                ready=spec.enabled and self.manager.engine_ready(spec),
                type=epb.PICTURE, task=spec.task)
            info.supported_samplers.extend(_engine_samplers())
            engines.append(info)
        return epb.Engines(engine=engines)
