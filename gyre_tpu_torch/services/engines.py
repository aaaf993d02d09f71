"""EnginesService: engine listing with capability report.

Counterpart of gyre_tpu/services/engines.py: every visible engine of the
requested task group, as the JAX servicer lists them. Generate engines
report every protocol sampler with its capabilities, and no prompt
artifacts (txt2img takes text prompts only).
"""

from __future__ import annotations

from ..generated import engines_pb2 as epb
from ..generated import generation_pb2 as gpb
from ..pipeline.samplers import PROTO_SAMPLERS, SAMPLER_PROPERTIES
from .exception_to_grpc import exception_to_grpc

_TASK_TO_GROUP = {
    "generate": epb.GENERATE,
    "upscaler": epb.UPSCALE,
    "upscale": epb.UPSCALE,
    "util": epb.UTILITY,
    "utility": epb.UTILITY,
    "hinter": epb.HINTER,
    "depth": epb.HINTER,
}

_NOISE = {"normal": gpb.SAMPLER_NOISE_NORMAL,
          "brownian": gpb.SAMPLER_NOISE_BROWNIAN}


def _engine_samplers():
    out = []
    for value, name in PROTO_SAMPLERS.items():
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
        want = request.task_group  # proto3 default GENERATE
        engines = []
        for spec in self.manager.specs:
            if not spec.visible or \
                    _TASK_TO_GROUP.get(spec.task, epb.GENERATE) != want:
                continue
            info = epb.EngineInfo(
                id=spec.id, name=spec.name, description=spec.description,
                owner="gyre-tpu",
                # as status(): resident weights and a path in the port
                ready=spec.enabled and self.manager.engine_ready(spec),
                type=epb.PICTURE, task=spec.task)
            if spec.task == "generate":
                info.supported_samplers.extend(_engine_samplers())
            engines.append(info)
        return epb.Engines(engine=engines)
