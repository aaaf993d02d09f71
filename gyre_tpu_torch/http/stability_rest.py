"""Stability REST v1 API (the reference's gyre/http/stability_rest_api.py
surface): engines list + text-to-image / image-to-image / masking, JSON and
multipart bodies, param clamping, png or base64-json responses.

Copy of gyre_tpu/http/stability_rest.py; its ops.images import is the
port's module."""

from __future__ import annotations

import base64
import json
import logging

import numpy as np

from ..generated import generation_pb2 as pb
from ..ops import images as I

logger = logging.getLogger(__name__)

SAMPLER_NAMES = {
    "DDIM": pb.SAMPLER_DDIM, "DDPM": pb.SAMPLER_DDPM,
    "K_EULER": pb.SAMPLER_K_EULER,
    "K_EULER_ANCESTRAL": pb.SAMPLER_K_EULER_ANCESTRAL,
    "K_HEUN": pb.SAMPLER_K_HEUN, "K_DPM_2": pb.SAMPLER_K_DPM_2,
    "K_DPM_2_ANCESTRAL": pb.SAMPLER_K_DPM_2_ANCESTRAL,
    "K_LMS": pb.SAMPLER_K_LMS,
    "K_DPMPP_2S_ANCESTRAL": pb.SAMPLER_K_DPMPP_2S_ANCESTRAL,
    "K_DPMPP_2M": pb.SAMPLER_K_DPMPP_2M,
    "K_DPMPP_SDE": pb.SAMPLER_K_DPMPP_SDE,
}


class RESTError(Exception):
    def __init__(self, status: int, name: str, message: str):
        self.status, self.name, self.message = status, name, message
        super().__init__(message)


# request limits mirror the reference (stability_rest_api.py:299-384);
# module-level so deployments/tests can adjust
LIMITS = {
    "height": (512, 2048),
    "width": (512, 2048),
    "steps": (1, 150),
    "samples": (1, 10),
    "cfg_scale": (0.0, 35.0),
    "image_strength": (0.0, 1.0),
}


def _clamp(v, name):
    lo, hi = LIMITS[name]
    if v < lo or v > hi:
        raise RESTError(400, "invalid_" + name,
                        f"{name} must be between {lo} and {hi}")
    return v


def build_request(engine_id: str, body: dict, kind: str,
                  files: dict[str, bytes] | None = None) -> pb.Request:
    files = files or {}
    req = pb.Request(engine_id=engine_id)

    if kind == "upscale":
        # reference StabilityRESTAPI_UpscaleController._prepare_request
        # (gyre/http/stability_rest_api.py:388-413): image + optional
        # target width/height
        img_data = files.get("image")
        if img_data is None and body.get("image"):
            img_data = base64.b64decode(body["image"])
        if img_data is None:
            raise RESTError(400, "missing_image",
                            "upscale requires an init image")
        prompt = req.prompt.add()
        prompt.parameters.init = True
        prompt.artifact.type = pb.ARTIFACT_IMAGE
        prompt.artifact.binary = img_data
        prompt.artifact.mime = "image/png"
        if "width" in body:
            req.image.width = _clamp(int(body["width"]), "width")
        if "height" in body:
            req.image.height = _clamp(int(body["height"]), "height")
        return req

    prompts = body.get("text_prompts") or []
    if not prompts:
        raise RESTError(400, "invalid_prompts", "text_prompts is required")
    for tp in prompts:
        prompt = req.prompt.add()
        prompt.text = str(tp.get("text", ""))
        if "weight" in tp and tp["weight"] is not None:
            prompt.parameters.weight = float(tp["weight"])

    img = req.image
    img.height = _clamp(int(body.get("height", 512)), "height")
    img.width = _clamp(int(body.get("width", 512)), "width")
    img.steps = _clamp(int(body.get("steps", 50)), "steps")
    img.samples = _clamp(int(body.get("samples", 1)), "samples")
    seed = int(body.get("seed", 0))
    if seed:
        img.seed.append(seed & (2 ** 32 - 1))

    sampler = str(body.get("sampler", "K_DPMPP_2M")).upper()
    img.transform.diffusion = SAMPLER_NAMES.get(sampler, pb.SAMPLER_K_DPMPP_2M)

    step_param = img.parameters.add()
    cfg = float(body.get("cfg_scale", 7.0))
    step_param.sampler.cfg_scale = _clamp(cfg, "cfg_scale")

    if kind in ("image-to-image", "masking"):
        init_data = files.get("init_image")
        if init_data is None and body.get("init_image"):
            init_data = base64.b64decode(body["init_image"])
        if init_data is None:
            raise RESTError(400, "missing_init_image",
                            "init_image is required")
        prompt = req.prompt.add()
        prompt.parameters.init = True
        prompt.artifact.type = pb.ARTIFACT_IMAGE
        prompt.artifact.binary = init_data
        prompt.artifact.mime = "image/png"
        if kind == "image-to-image":
            mode = body.get("init_image_mode", "IMAGE_STRENGTH")
            if mode == "IMAGE_STRENGTH":
                strength = float(body.get("image_strength", 0.35))
            else:
                strength = 1.0 - float(body.get("step_schedule_start", 0.65))
            step_param.schedule.start = _clamp(strength, "image_strength")
        else:
            mask_source = body.get("mask_source", "MASK_IMAGE_WHITE")
            mask_data = files.get("mask_image")
            if mask_data is None and body.get("mask_image"):
                mask_data = base64.b64decode(body["mask_image"])
            mask_prompt = req.prompt.add()
            mask_prompt.artifact.type = pb.ARTIFACT_MASK
            mask_prompt.artifact.mime = "image/png"
            if mask_source == "INIT_IMAGE_ALPHA":
                # white where alpha==0 (transparent = regenerate)
                arr = I.decode_png(init_data)
                alpha = arr[..., 3:] if arr.shape[-1] == 4 else \
                    np.ones_like(arr[..., :1])
                mask_prompt.artifact.binary = I.encode_png(1.0 - alpha)
            elif mask_data is not None:
                if mask_source == "MASK_IMAGE_BLACK":
                    arr = I.decode_png(mask_data)
                    mask_prompt.artifact.binary = I.encode_png(
                        1.0 - arr[..., :1])
                else:
                    mask_prompt.artifact.binary = mask_data
            else:
                raise RESTError(400, "missing_mask", "mask_image is required")
    return req


def answers_to_response(answers, accept: str = "application/json"):
    """-> (status, content_type, body_bytes)."""
    artifacts = []
    for a in answers:
        artifacts.extend(a.artifacts)
    images = [a for a in artifacts if a.type == pb.ARTIFACT_IMAGE]
    if not images:
        raise RESTError(500, "no_image", "generation produced no images")
    if accept == "image/png":
        return 200, "image/png", images[0].binary
    payload = {"artifacts": [
        {"base64": base64.b64encode(a.binary).decode(),
         "seed": a.seed,
         "finishReason": pb.FinishReason.Name(a.finish_reason)}
        for a in images]}
    return 200, "application/json", json.dumps(payload).encode()


def engines_list_response(manager):
    out = [{"id": s.id, "name": s.name, "description": s.description,
            "type": "PICTURE"}
           for s in manager.specs if s.visible and s.task == "generate"]
    return 200, "application/json", json.dumps(out).encode()
