"""A tiny cell for the CPU tests: the port's ``test`` preset written out
as a configuration in the published diffusers layouts, a few clients, a
64x64 image."""

from __future__ import annotations

SEED = 3_000_000_019


def test_config() -> dict:
    from gyre_tpu_torch.models import configs as C

    cfg = C.SD_TEST
    te = C.clip_config_to_diffusers(cfg.text_encoders[0])
    te["hidden_act"] = cfg.text_encoders[0].activation
    unet = C.unet_config_to_diffusers(cfg.unet, cfg.sample_size)
    # as the published SD1.x files write it (the mid block takes the last
    # entry of a list)
    unet["transformer_layers_per_block"] = 1
    return {"name": "test", "source": "the port's test preset",
            "family": "sd", "preset": "test", "reduced": [],
            "serving": {"clip_layer": cfg.clip_layer, "dtype": "float32"},
            "unet": unet,
            "vae": C.vae_config_to_diffusers(cfg.vae),
            "text_encoder": te,
            "scheduler": {"beta_start": 0.00085, "beta_end": 0.012,
                          "num_train_timesteps": 1000,
                          "prediction_type": "epsilon"}}


def test_cell(clients: int = 3, steps: int = 20, batch_max: int = 2) -> dict:
    from benchmark import traffic

    mix = {"loop": "closed", "clients": clients, "height": 64, "width": 64,
           "steps": steps, "sampler": "k_dpmpp_2m", "cfg_scale": 7.5,
           "prompt_words": [5, 40], "negative_share": 0.5,
           "negative_words": [3, 12], "words": "words.txt",
           "words_path": str(traffic.HERE / "traffic" / "words.txt"),
           "requests_per_client": 8}
    workload = {"config": "test", "traffic": "tiny", "chips": 1,
                "why": "a CPU test", "server": {"batch_max": batch_max},
                "trace": {"start": 0.25, "stop": 0.75},
                "check": {"sample": 4, "block": 2,
                          "limits": {"image_mean_gap": 0.5,
                                     "image_max_gap": 2}}}
    return {"entry": {"name": "test.tiny", "config": "test",
                      "traffic": "tiny", "chips": 1},
            "workload": workload, "config": test_config(), "mix": mix}
