"""The one traffic generator: a mix's parameters (a JSON file under
``traffic/``) and the run's seed give each closed-loop client its own
sequence of txt2img requests.

Every request asks for one image of the mix's size, steps, sampler and
CFG scale, so every seed sends the same work in another order. A prompt
has a word count uniform in ``prompt_words`` drawn from the word list;
exactly ``negative_share`` of each client's requests carry a negative
prompt of ``negative_words`` words; request seeds are uniform in
[1, 2^31) (the server replaces a seed of 0 with a random one).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def client_requests(mix: dict, seed: int) -> list[list[dict]]:
    """[client][i] -> {"prompt", "negative_prompt", "seed", "height",
    "width", "steps", "sampler", "cfg_scale"}."""
    words = Path(mix.get("words_path") or HERE / "traffic" /
                 mix["words"]).read_text().split()
    rng = np.random.default_rng([int(seed), 0x7261666669])
    n = int(mix["requests_per_client"])
    lo, hi = mix["prompt_words"]
    nlo, nhi = mix["negative_words"]
    out = []
    for _ in range(int(mix["clients"])):
        neg = np.zeros(n, bool)
        neg[:int(round(n * float(mix["negative_share"])))] = True
        rng.shuffle(neg)
        reqs = []
        for i in range(n):
            k = int(rng.integers(lo, hi + 1))
            prompt = " ".join(rng.choice(words, k))
            negative = ""
            if neg[i]:
                negative = " ".join(rng.choice(
                    words, int(rng.integers(nlo, nhi + 1))))
            reqs.append({"prompt": prompt, "negative_prompt": negative,
                         "seed": int(rng.integers(1, 2 ** 31)),
                         "height": int(mix["height"]),
                         "width": int(mix["width"]),
                         "steps": int(mix["steps"]),
                         "sampler": mix["sampler"],
                         "cfg_scale": float(mix["cfg_scale"])})
        out.append(reqs)
    return out
