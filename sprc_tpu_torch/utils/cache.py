"""Artifact cache and URL helpers (counterpart of ``sprc_tpu/utils/cache.py``;
the reference common/utils.py subset: ``is_url``, the cache path of a URL,
a cached download).

Nothing here fetches: :func:`download_cached_file` resolves a URL to an
entry of the cache that is already on disk and raises otherwise, naming
the path to place the file at. The cache root is ``$SPRC_CACHE`` or
``~/.cache/sprc_tpu_torch``.
"""

from __future__ import annotations

import hashlib
import os
import urllib.parse


def is_url(path: str) -> bool:
    return urllib.parse.urlparse(path).scheme in ("http", "https")


def cache_root() -> str:
    root = os.environ.get("SPRC_CACHE", os.path.expanduser("~/.cache/sprc_tpu_torch"))
    os.makedirs(root, exist_ok=True)
    return root


def get_cache_path(rel_path: str) -> str:
    return os.path.join(cache_root(), rel_path)


def cached_path(url_or_path: str) -> str:
    """A URL -> its cache path (a digest of the URL and its file name); a
    local path as it is."""
    if not is_url(url_or_path):
        return url_or_path
    name = os.path.basename(urllib.parse.urlparse(url_or_path).path)
    digest = hashlib.sha256(url_or_path.encode()).hexdigest()[:16]
    return get_cache_path(f"{digest}_{name}")


def download_cached_file(url: str) -> str:
    """The cache entry of ``url``; a ``FileNotFoundError`` that names where
    to place it when there is none."""
    target = cached_path(url)
    if os.path.exists(target):
        return target
    raise FileNotFoundError(f"artifact for {url} not in the cache ({target}): this package "
                            "downloads nothing; place the file there")
