"""Staged data (counterpart of ``euler_tpu/graph/remote_fs.py``): graph
directories and files behind fsspec URLs (``gs://``, ``s3://``,
``hdfs://``, ``memory://``, anything fsspec resolves), staged to a local
cache or streamed into memory before the engine loads them.

The engine keeps one local read path. A remote directory is staged once
into ``cache_dir`` (default ``$EULER_TPU_CACHE``, else
``~/.cache/euler_tpu/staged``), or, with ``Graph(stream=True)``, its
partitions are fetched into memory and parsed from there
(``eg_load_buffers``) with no local copy. Either way a shard fetches only
its own partitions: the engine's rule, partition ``p`` of ``*_<p>.dat``
(no suffix: 0) kept when ``p % shard_num == shard_idx``.

Staging is idempotent and safe under concurrent stagers: a file lands
under a temporary name unique to the process and thread and is renamed
into place; a file cached at the remote size is not fetched again, and a
cached file the remote listing no longer holds is removed. A protocol
without its fsspec driver (gcsfs for ``gs://``, s3fs for ``s3://``)
raises naming the package. Duplicate URLs in a file list raise: the
engine merges files sorted by name, and equal names would leave the
built store's order unspecified.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

_PART_RE = re.compile(r"_(\d+)\.dat$")

#: schemes that are plain local paths even though they carry a "://"
_LOCAL_SCHEMES = ("file", "local")


def is_remote_path(path: str) -> bool:
    """True for URLs that need staging (``gs://``, ``s3://``, ...)."""
    if "://" not in path:
        return False
    return path.split("://", 1)[0] not in _LOCAL_SCHEMES


def strip_local_scheme(path: str) -> str:
    """``file:///data/x`` -> ``/data/x``; plain paths pass through."""
    for scheme in _LOCAL_SCHEMES:
        prefix = scheme + "://"
        if path.startswith(prefix):
            return path[len(prefix):] or "/"
    return path


def default_cache_dir() -> str:
    return os.environ.get(
        "EULER_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "euler_tpu",
                     "staged"))


def _filesystem(url: str):
    try:
        import fsspec
    except ImportError as e:
        raise RuntimeError(f"loading {url} needs the fsspec package") from e
    try:
        return fsspec.core.url_to_fs(url)
    except (ImportError, ValueError) as e:
        scheme = url.split("://", 1)[0]
        raise RuntimeError(
            f"no fsspec driver installed for {scheme}:// "
            f"(install e.g. gcsfs for gs://, s3fs for s3://): {e}") from e


def partition_index(name: str) -> int:
    """The trailing ``_<p>.dat`` partition index; -1 when absent (the
    engine's parser, so staging and local loads pick the same files)."""
    m = _PART_RE.search(os.path.basename(name))
    return int(m.group(1)) if m else -1


def _fetch(fs, remote: str, local: str) -> None:
    # a temporary name per process and thread: concurrent stagers never
    # write into one partial file; the rename publishes whole files only
    tmp = f"{local}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        fs.get_file(remote, tmp)
        os.replace(tmp, local)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _shard_partitions(fs, root: str, shard_idx: int, shard_num: int,
                      url: str | None = None):
    """This shard's ``.dat`` entries under ``root`` and the
    ``meta.json`` entry (or None): the one copy of the selection rule,
    shared by staged and streamed loads. A name without a ``_<p>``
    suffix is partition 0, as the engine reads it."""
    picked = []
    meta = None
    for ent in fs.ls(root, detail=True):
        name = os.path.basename(ent["name"])
        if name == "meta.json":
            meta = ent
            continue
        if not name.endswith(".dat"):
            continue
        p = max(partition_index(name), 0)
        if shard_num > 1 and p % shard_num != shard_idx:
            continue
        picked.append(ent)
    if not picked:
        # the URL the caller passed, not the scheme-stripped root
        raise FileNotFoundError(
            f"no .dat partitions for shard {shard_idx}/{shard_num} "
            f"in {url or root}")
    return picked, meta


def stage_directory(url: str, cache_dir: str | None = None,
                    shard_idx: int = 0, shard_num: int = 1,
                    refresh: bool = False) -> str:
    """Download this shard's ``.dat`` partitions of a remote directory
    (and its ``meta.json``) into the cache; returns the local directory,
    keyed by the URL and the shard selection."""
    fs, root = _filesystem(url)
    key = hashlib.sha1(f"{url}|{shard_idx}/{shard_num}".encode()
                       ).hexdigest()[:16]
    out = os.path.join(cache_dir or default_cache_dir(), key)
    os.makedirs(out, exist_ok=True)
    picked, meta = _shard_partitions(fs, root, shard_idx, shard_num, url)
    want = picked + ([meta] if meta else [])
    keep = {os.path.basename(e["name"]) for e in want}
    # a repartitioned dataset at the same URL must not mix old and new
    # files; .tmp.* files may belong to a concurrent stager
    for name in os.listdir(out):
        if name not in keep and ".tmp." not in name:
            os.unlink(os.path.join(out, name))

    def fetch_one(ent):
        local = os.path.join(out, os.path.basename(ent["name"]))
        size = ent.get("size")
        if (not refresh and size is not None and os.path.exists(local)
                and os.path.getsize(local) == size):
            return
        _fetch(fs, ent["name"], local)

    # object stores serve one object well below the host's bandwidth
    with ThreadPoolExecutor(max_workers=min(8, len(want))) as ex:
        list(ex.map(fetch_one, want))
    return out


def read_directory(url: str, shard_idx: int = 0,
                   shard_num: int = 1) -> list[tuple[str, bytes]]:
    """This shard's ``.dat`` partitions fetched into memory, as
    ``(basename, bytes)`` pairs: the streamed load
    (``Graph(stream=True)``), which needs no local disk. The engine
    sorts them by name, so the order of fetches cannot change the store.
    At its peak the load holds the raw bytes, their parse copies and the
    built store: about two to three times the store."""
    fs, root = _filesystem(url)
    picked, _ = _shard_partitions(fs, root, shard_idx, shard_num, url)
    names = [ent["name"] for ent in picked]
    with ThreadPoolExecutor(max_workers=min(8, len(names))) as ex:
        blobs = list(ex.map(fs.cat_file, names))
    return [(os.path.basename(p), b) for p, b in zip(names, blobs)]


def _reject_duplicates(urls: list[str]) -> None:
    seen: set[str] = set()
    dups = sorted({u for u in urls if u in seen or seen.add(u)})
    if dups:
        raise ValueError(
            f"duplicate file URL(s) in files=: {dups} (the native merge "
            "sorts by name, so every name must be unique for a "
            "deterministic store)")


def read_files(urls: list[str]) -> list[tuple[str, bytes]]:
    """The streamed form of ``stage_files``: each file's bytes, remote
    through fsspec and local off disk, named by its full URL (basenames
    of a file list can collide). Duplicates raise."""
    _reject_duplicates(urls)

    def fetch_one(url: str) -> tuple[str, bytes]:
        if is_remote_path(url):
            fs, path = _filesystem(url)
            try:
                return url, fs.cat_file(path)
            except FileNotFoundError:
                raise FileNotFoundError(f"no such remote file: {url}")
        with open(strip_local_scheme(url), "rb") as f:
            return url, f.read()

    if not urls:
        return []
    with ThreadPoolExecutor(max_workers=min(8, len(urls))) as ex:
        return list(ex.map(fetch_one, urls))


def stage_files(urls: list[str], cache_dir: str | None = None,
                refresh: bool = False) -> list[str]:
    """Stage an explicit file list, one cache directory a URL; local
    paths pass through. Duplicates raise, as in ``read_files``."""
    _reject_duplicates(urls)
    out = []
    for url in urls:
        if not is_remote_path(url):
            out.append(strip_local_scheme(url))
            continue
        fs, path = _filesystem(url)
        key = hashlib.sha1(url.encode()).hexdigest()[:16]
        d = os.path.join(cache_dir or default_cache_dir(), key)
        os.makedirs(d, exist_ok=True)
        local = os.path.join(d, os.path.basename(path))
        try:
            size = fs.info(path).get("size")
        except FileNotFoundError:
            raise FileNotFoundError(f"no such remote file: {url}")
        if (refresh or size is None or not os.path.exists(local)
                or os.path.getsize(local) != size):
            _fetch(fs, path, local)
        out.append(local)
    return out


def clear_cache(cache_dir: str | None = None) -> None:
    d = cache_dir or default_cache_dir()
    if os.path.isdir(d):
        shutil.rmtree(d)
