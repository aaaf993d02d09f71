"""Weight resolution: candidate chains from model references to loadable
checkpoint directories/files (reference _get_weight_path_candidates,
gyre/manager.py:975-1022, HF repo-listing heuristics :684-896, civitai
gyre/civitai.py:40-133 with SHA256 verification, generic URL cache
:924-973).

Network tiers (activated with allow_network=True):

  * HF hub: list the repo's files via the hub API, then either snapshot-
    download a diffusers-layout repo (model_index.json) with the
    safetensors/fp16 variant heuristics the reference applies, or pick the
    single best checkpoint file (safetensors > ckpt > pt > bin, fp16
    variant preferred).
  * civitai: resolve model/version pages through the civitai API to the
    primary file's download URL + published SHA256, verify after download,
    re-download once on mismatch (reference --refresh_on_error semantics).
  * generic URLs: cached by content hash of the URL.

In zero-egress deployments only local candidates resolve. The network
primitives (fetch_json / fetch_file) are instance methods so tests can
exercise the full heuristics offline.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from dataclasses import dataclass

logger = logging.getLogger(__name__)

_CIVITAI_URL = re.compile(
    r"https?://civitai\.com/(?:models/(?P<model>\d+)|"
    r"api/download/models/(?P<version>\d+))")

HF_API = "https://huggingface.co/api/models/{repo}"
HF_RESOLVE = "https://huggingface.co/{repo}/resolve/{rev}/{file}"
CIVITAI_MODEL_API = "https://civitai.com/api/v1/models/{model_id}"
CIVITAI_VERSION_API = "https://civitai.com/api/v1/model-versions/{version_id}"

# single-file checkpoint preference, best first
_CKPT_EXT_ORDER = (".safetensors", ".ckpt", ".pt", ".bin")
# repo files never worth downloading for inference
_SKIP_SUFFIXES = (".onnx", ".msgpack", ".h5", ".md", ".png", ".jpg",
                  ".gitattributes", ".onnx_data")


@dataclass
class Candidate:
    kind: str       # local | local_fp16 | hf_cache | hf_download | civitai | url
    path: str
    exists: bool = False


def parse_civitai_ref(url: str) -> dict | None:
    m = _CIVITAI_URL.match(url)
    if not m:
        return None
    return {"model_id": m.group("model"), "version_id": m.group("version")}


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            data = fh.read(chunk)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def verify_sha256(path: str, expected: str) -> bool:
    """Civitai publishes SHA256 per file; corrupt caches re-download
    (reference --refresh_on_error semantics)."""
    got = sha256_file(path)
    ok = got.lower() == expected.lower()
    if not ok:
        logger.warning("sha256 mismatch for %s: %s != %s", path, got,
                       expected)
    return ok


def _variant_stem(name: str) -> tuple[str, bool]:
    """('unet/model', True) for 'unet/model.fp16.safetensors' — stem without
    variant/extension plus whether it's the fp16 variant."""
    base = name
    for ext in _CKPT_EXT_ORDER:
        if base.endswith(ext):
            base = base[:-len(ext)]
            break
    fp16 = base.endswith(".fp16")
    if fp16:
        base = base[:-5]
    return base, fp16


def select_repo_files(files: list[str], prefer_fp16: bool = True) -> list[str]:
    """The reference's HF file heuristics (gyre/manager.py:684-896) over a
    repo file listing: keep configs/tokenizers, keep ONE weight file per
    stem — safetensors over bin/pt, fp16 variant when preferred and
    available — and drop formats inference never needs."""
    weights: dict[str, dict] = {}   # stem -> {(fp16, ext): name}
    keep: list[str] = []
    for name in files:
        if name.endswith(_SKIP_SUFFIXES) or name.startswith("."):
            continue
        ext = next((e for e in _CKPT_EXT_ORDER if name.endswith(e)), None)
        if ext is None:
            keep.append(name)       # config.json, merges.txt, tokenizer...
            continue
        stem, fp16 = _variant_stem(name)
        weights.setdefault(stem, {})[(fp16, ext)] = name
    for stem, variants in weights.items():
        ranked = sorted(
            variants.items(),
            key=lambda kv: (
                # prefer requested variant, then better extension
                0 if kv[0][0] == prefer_fp16 else 1,
                _CKPT_EXT_ORDER.index(kv[0][1]),
            ))
        keep.append(ranked[0][1])
    return sorted(keep)


def pick_single_checkpoint(files: list[str],
                           prefer_fp16: bool = True) -> str | None:
    """Best single checkpoint file in a non-diffusers repo."""
    cands = [f for f in files
             if f.endswith(_CKPT_EXT_ORDER) and "/" not in f]
    if not cands:
        cands = [f for f in files if f.endswith(_CKPT_EXT_ORDER)]
    if not cands:
        return None

    def rank(name):
        stem, fp16 = _variant_stem(name)
        ext = next(e for e in _CKPT_EXT_ORDER if name.endswith(e))
        return (0 if fp16 == prefer_fp16 else 1,
                _CKPT_EXT_ORDER.index(ext), len(name))

    return sorted(cands, key=rank)[0]


class WeightResolver:
    def __init__(self, local_dirs: list[str] | None = None,
                 hf_cache: str | None = None,
                 download_cache: str = "/tmp/gyre-weights",
                 allow_network: bool = False, prefer_fp16: bool = True,
                 hf_revision: str = "main"):
        self.local_dirs = local_dirs or ["./weights"]
        self.hf_cache = hf_cache or os.environ.get(
            "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
        self.download_cache = download_cache
        self.allow_network = allow_network
        self.prefer_fp16 = prefer_fp16
        self.hf_revision = hf_revision

    # ------------------------------------------------ network primitives
    # instance methods so tests monkeypatch them and drive the full
    # selection/verification logic offline

    def fetch_json(self, url: str):
        import urllib.request

        with urllib.request.urlopen(url, timeout=120) as resp:
            return json.load(resp)

    def fetch_file(self, url: str, dest: str) -> str:
        import urllib.request

        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        tmp = dest + ".part"
        with urllib.request.urlopen(url, timeout=600) as resp, \
                open(tmp, "wb") as fh:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                fh.write(chunk)
        os.replace(tmp, dest)
        return dest

    # ------------------------------------------------------------- chain

    def candidates(self, ref: str) -> list[Candidate]:
        """Ordered candidate chain for a model reference (local path,
        'org/repo' HF id, or URL)."""
        out: list[Candidate] = []
        if os.path.isabs(ref) or ref.startswith((".", "/")):
            out.append(Candidate("local", ref, os.path.exists(ref)))
            return out
        if ref.startswith(("http://", "https://")):
            civ = parse_civitai_ref(ref)
            cache_name = hashlib.sha1(ref.encode()).hexdigest()[:16] + \
                ".safetensors"
            cached = os.path.join(self.download_cache, cache_name)
            out.append(Candidate("url_cache", cached, os.path.exists(cached)))
            out.append(Candidate("civitai" if civ else "url", ref,
                                 self.allow_network))
            return out
        # HF-style "org/repo[@revision][/subfolder]"
        repo = ref.split("@")[0]
        for base in self.local_dirs:
            local = os.path.join(base, repo.replace("/", "--"))
            if self.prefer_fp16:
                out.append(Candidate("local_fp16", local + "--fp16",
                                     os.path.isdir(local + "--fp16")))
            out.append(Candidate("local", local, os.path.isdir(local)))
            plain = os.path.join(base, repo.split("/")[-1])
            out.append(Candidate("local", plain, os.path.isdir(plain)))
        hub_dir = os.path.join(self.hf_cache, "hub",
                               "models--" + repo.replace("/", "--"))
        snap = os.path.join(hub_dir, "snapshots")
        if os.path.isdir(snap):
            revs = sorted(os.listdir(snap))
            # prefer the commit refs/main points at (a lexicographic pick
            # can land on a stale revision in multi-snapshot caches)
            ref_main = os.path.join(hub_dir, "refs", "main")
            if os.path.exists(ref_main):
                with open(ref_main) as f:
                    head = f.read().strip()
                if head in revs:
                    revs = [r for r in revs if r != head] + [head]
            if revs:
                out.append(Candidate("hf_cache",
                                     os.path.join(snap, revs[-1]), True))
        # prior hub downloads land in the download cache; single-file
        # checkpoints resolve to the file itself
        prior = os.path.join(self.download_cache, "hf",
                             repo.replace("/", "--"))
        if os.path.isdir(prior):
            entries = os.listdir(prior)
            if "model_index.json" not in entries and len(entries) == 1 and \
                    entries[0].endswith(_CKPT_EXT_ORDER):
                prior = os.path.join(prior, entries[0])
            out.append(Candidate("local", prior, True))
        out.append(Candidate("hf_download", repo, self.allow_network))
        return out

    def resolve(self, ref: str, refresh: bool = False,
                subfolder: str | None = None,
                allow_patterns: str | list[str] | None = None) -> str:
        """First existing/fetchable candidate -> local path. refresh=True
        skips caches and re-downloads (reference forced re-download tier,
        gyre/manager.py:1564-1600). subfolder/allow_patterns narrow an HF
        repo to specific files (reference model-config keys,
        gyre/config/models/t2i.yaml)."""
        chain = self.candidates(ref)
        if not refresh:
            for cand in chain:
                if cand.exists and cand.kind in ("local", "local_fp16",
                                                 "hf_cache", "url_cache"):
                    logger.info("weights %s -> %s (%s)", ref, cand.path,
                                cand.kind)
                    path = cand.path
                    if subfolder and os.path.isdir(
                            os.path.join(path, subfolder)):
                        path = os.path.join(path, subfolder)
                    return path
        for cand in chain:
            if cand.kind in ("civitai", "url", "hf_download") and \
                    cand.exists:
                return self._download(ref, cand, force=refresh,
                                      subfolder=subfolder,
                                      allow_patterns=allow_patterns)
        raise FileNotFoundError(
            f"no weight candidates for {ref!r}; tried " +
            ", ".join(f"{c.kind}:{c.path}" for c in chain))

    # -------------------------------------------------------- downloads

    def _download(self, ref: str, cand: Candidate, force: bool = False,
                  subfolder=None, allow_patterns=None) -> str:
        if not self.allow_network:
            raise FileNotFoundError(f"network disabled; cannot fetch {ref}")
        os.makedirs(self.download_cache, exist_ok=True)
        if cand.kind == "hf_download":
            return self._hf_download(cand.path, force=force,
                                     subfolder=subfolder,
                                     allow_patterns=allow_patterns)
        if cand.kind == "civitai":
            return self._civitai_download(ref)
        # generic URL
        name = hashlib.sha1(ref.encode()).hexdigest()[:16] + ".safetensors"
        dest = os.path.join(self.download_cache, name)
        logger.info("downloading %s -> %s", ref, dest)
        return self.fetch_file(cand.path, dest)

    def _hf_download(self, repo: str, force: bool = False,
                     subfolder=None, allow_patterns=None) -> str:
        """Repo file listing -> variant selection -> snapshot download
        (reference _get_hf_path heuristics, gyre/manager.py:684-896, and
        snapshot_download usage :1254-1294)."""
        info = self.fetch_json(HF_API.format(repo=repo))
        files = [s["rfilename"] for s in info.get("siblings", [])]
        if subfolder:
            files = [f for f in files
                     if f.startswith(subfolder.rstrip("/") + "/")]
        if allow_patterns:
            import fnmatch
            pats = [allow_patterns] if isinstance(allow_patterns, str) \
                else list(allow_patterns)
            files = [f for f in files
                     if any(fnmatch.fnmatch(os.path.basename(f), p) or
                            fnmatch.fnmatch(f, p) for p in pats)]
        if not files:
            raise FileNotFoundError(f"HF repo {repo} lists no files"
                                    + (f" under {subfolder}/" if subfolder
                                       else ""))
        dest_dir = os.path.join(self.download_cache, "hf",
                                repo.replace("/", "--"))
        rev = self.hf_revision
        if "model_index.json" in files:
            wanted = select_repo_files(files, self.prefer_fp16)
            logger.info("hf snapshot %s: %d/%d files", repo, len(wanted),
                        len(files))
            for name in wanted:
                out = os.path.join(dest_dir, name)
                if os.path.exists(out) and not force:
                    continue
                self.fetch_file(
                    HF_RESOLVE.format(repo=repo, rev=rev, file=name), out)
            return dest_dir
        best = pick_single_checkpoint(files, self.prefer_fp16)
        if best is None:
            # config-only repos (e.g. schedulers): take everything kept
            wanted = select_repo_files(files, self.prefer_fp16)
            for name in wanted:
                out = os.path.join(dest_dir, name)
                if not os.path.exists(out):
                    self.fetch_file(
                        HF_RESOLVE.format(repo=repo, rev=rev, file=name),
                        out)
            return dest_dir
        out = os.path.join(dest_dir, os.path.basename(best))
        if force or not os.path.exists(out):
            logger.info("hf checkpoint %s: %s", repo, best)
            self.fetch_file(HF_RESOLVE.format(repo=repo, rev=rev, file=best),
                            out)
        return out

    def _civitai_download(self, ref: str) -> str:
        """Model/version page -> API metadata -> primary file + SHA256
        verify, one retry on mismatch (reference gyre/civitai.py:40-133)."""
        parsed = parse_civitai_ref(ref)
        if parsed["version_id"]:
            meta = self.fetch_json(CIVITAI_VERSION_API.format(
                version_id=parsed["version_id"]))
        else:
            model = self.fetch_json(CIVITAI_MODEL_API.format(
                model_id=parsed["model_id"]))
            versions = model.get("modelVersions") or []
            if not versions:
                raise FileNotFoundError(f"civitai model {ref} has no "
                                        "versions")
            meta = versions[0]
        files = meta.get("files") or []
        primary = next((f for f in files if f.get("primary")), None) or \
            (files[0] if files else None)
        if primary is None:
            raise FileNotFoundError(f"civitai {ref} lists no files")
        url = primary.get("downloadUrl") or ref
        expected = (primary.get("hashes") or {}).get("SHA256")
        cache_name = hashlib.sha1(ref.encode()).hexdigest()[:16] + \
            ".safetensors"
        dest = os.path.join(self.download_cache, cache_name)
        for attempt in range(2):
            logger.info("civitai download %s -> %s (try %d)", url, dest,
                        attempt + 1)
            self.fetch_file(url, dest)
            if not expected or verify_sha256(dest, expected):
                return dest
            os.remove(dest)
        raise OSError(f"civitai download {ref} failed SHA256 verification "
                      "twice")
