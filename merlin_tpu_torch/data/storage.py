"""Object-store access with reference credential semantics (a copy of
``merlin_tpu/data/storage.py``).

The reference authenticates to S3-compatible stores through an internal
``s3_path`` helper + boto3/megfile (base_dataset.py:33-35: access key /
secret from a token provider, custom ``endpoint_url``) and opens
everything through ``megfile.smart_open``. This module is the behavioral
equivalent on a training host:

  * credentials/endpoint come from the standard environment
    (``AWS_ACCESS_KEY_ID`` / ``AWS_SECRET_ACCESS_KEY`` /
    ``AWS_SESSION_TOKEN`` and ``AWS_ENDPOINT_URL`` — also accepted:
    ``S3_ENDPOINT`` / ``OSS_ENDPOINT``, the names the reference's
    internal provider maps to);
  * :func:`smart_open` dispatches s3:// URLs to boto3 when importable,
    else to the in-repo stdlib SigV4 client (:mod:`.s3http`) when
    credentials are present, else to fsspec/s3fs, else raises with an
    actionable message; every other scheme goes through fsspec; plain
    paths through ``open``;
  * :func:`list_keys` expands an s3:// prefix/glob (registry shard
    expansion) via boto3/s3http pagination or fsspec glob.

boto3/s3fs are NOT installed in the CI environment — the boto3 branch is
unit-tested against a fake boto3 client, and the stdlib branch is
WIRE-tested against a loopback S3 server that independently re-derives
the SigV4 signature and paginates ListObjectsV2 (tests/test_torch_storage.py).
"""

from __future__ import annotations

import io
import os
import re
from typing import Dict, List, Optional, Tuple


def s3_credentials() -> Dict[str, Optional[str]]:
    """Reference get_access_token()/get_endpoint_url() equivalent."""
    env = os.environ
    return {
        "aws_access_key_id": env.get("AWS_ACCESS_KEY_ID"),
        "aws_secret_access_key": env.get("AWS_SECRET_ACCESS_KEY"),
        "aws_session_token": env.get("AWS_SESSION_TOKEN"),
        "endpoint_url": (env.get("AWS_ENDPOINT_URL")
                         or env.get("S3_ENDPOINT")
                         or env.get("OSS_ENDPOINT")),
        "region": (env.get("AWS_REGION")
                   or env.get("AWS_DEFAULT_REGION") or "us-east-1"),
    }


def _split_s3(url: str) -> Tuple[str, str]:
    rest = url[len("s3://"):]
    bucket, _, key = rest.partition("/")
    return bucket, key


# single-entry cache {key: client}: boto3 clients are thread-safe and a
# fresh Session per open() costs ~100ms of config/endpoint resolution.
# Replaced (not appended) when credentials rotate — an STS token that
# refreshes hourly must not accumulate dead clients + connection pools.
_CLIENT_CACHE: Dict[Tuple[Optional[str], ...], object] = {}


def _boto3_client():
    import boto3  # gated: absent in CI, present on real hosts

    creds = s3_credentials()
    cache_key = (creds["aws_access_key_id"], creds["aws_secret_access_key"],
                 creds["aws_session_token"], creds["endpoint_url"])
    client = _CLIENT_CACHE.get(cache_key)
    if client is None:
        session = boto3.Session(
            aws_access_key_id=creds["aws_access_key_id"],
            aws_secret_access_key=creds["aws_secret_access_key"],
            aws_session_token=creds["aws_session_token"])
        client = session.client("s3", endpoint_url=creds["endpoint_url"])
        _CLIENT_CACHE.clear()
        _CLIENT_CACHE[cache_key] = client
    return client


def _s3_client():
    """boto3 when importable, else the in-repo stdlib SigV4 client
    (same get_object/list_objects_v2 call shapes). Raises ImportError
    only when neither can serve — callers then fall through to fsspec."""
    try:
        return _boto3_client()
    except ImportError:
        creds = s3_credentials()
        if not (creds["aws_access_key_id"]
                and creds["aws_secret_access_key"]):
            raise  # anonymous fsspec/s3fs may still work
        from merlin_tpu_torch.data.s3http import S3HttpClient

        cache_key = ("s3http", creds["aws_access_key_id"],
                     creds["aws_secret_access_key"],
                     creds["aws_session_token"], creds["endpoint_url"],
                     creds["region"])
        client = _CLIENT_CACHE.get(cache_key)
        if client is None:
            client = S3HttpClient(
                creds["aws_access_key_id"],
                creds["aws_secret_access_key"],
                session_token=creds["aws_session_token"],
                endpoint_url=creds["endpoint_url"],
                region=creds["region"])
            _CLIENT_CACHE.clear()
            _CLIENT_CACHE[cache_key] = client
    return client


def smart_open(path: str, mode: str = "rb"):
    """megfile.smart_open equivalent: s3://, any fsspec scheme, or local.

    s3 reads return a buffered file-like over the streaming body (one GET
    per open — tar streaming reads sequentially, so no range requests are
    needed)."""
    if path.startswith("s3://"):
        if "w" in mode or "a" in mode:
            raise NotImplementedError("object-store writes are not part "
                                      "of the data path")
        try:
            client = _s3_client()
        except ImportError:
            return _fsspec_open(path, mode)
        bucket, key = _split_s3(path)
        body = client.get_object(Bucket=bucket, Key=key)["Body"]
        raw = _StreamingBodyFile(body)
        if "b" in mode:
            return io.BufferedReader(raw)
        return io.TextIOWrapper(io.BufferedReader(raw))
    if "://" in path:
        return _fsspec_open(path, mode)
    return open(path, mode)


def _fsspec_open(path: str, mode: str):
    try:
        import fsspec
    except ImportError as e:
        raise RuntimeError(
            f"cannot open {path!r}: neither boto3 nor fsspec is available "
            "(pip install boto3 or s3fs on the host)") from e
    kw = {}
    if path.startswith("s3://"):
        creds = s3_credentials()
        kw = {"key": creds["aws_access_key_id"],
              "secret": creds["aws_secret_access_key"],
              "token": creds["aws_session_token"],
              "client_kwargs": {"endpoint_url": creds["endpoint_url"]}
              if creds["endpoint_url"] else {}}
    return fsspec.open(path, mode, **kw).open()


class _StreamingBodyFile(io.RawIOBase):
    """boto3 StreamingBody -> RawIOBase so BufferedReader/TextIOWrapper
    (and tarfile's stream mode) can sit on top."""

    def __init__(self, body):
        self._body = body

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        chunk = self._body.read(len(b))
        n = len(chunk)
        b[:n] = chunk
        return n

    def close(self):
        try:
            self._body.close()
        finally:
            super().close()


def _glob_re(pattern: str) -> "re.Pattern":
    """Glob -> regex with path-glob semantics (``*``/``?`` stop at ``/``,
    ``**`` crosses directories, matching ZERO components too:
    ``a/**/b.tar`` matches ``a/b.tar``) — matches fs.glob/
    megfile.smart_glob; fnmatch would let ``shards/*.tar`` swallow
    ``shards/sub/x.tar``."""
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "*":
            if pattern[i:i + 2] == "**":
                if pattern[i:i + 3] == "**/":
                    # globstar + separator as one unit so zero components
                    # match ('a/**/b' ~ 'a/b'), like fs.glob
                    out.append("(?:.*/)?")
                    i += 3
                else:
                    out.append(".*")
                    i += 2
                continue
            out.append("[^/]*")
        elif ch == "?":
            out.append("[^/]")
        elif ch == "[":
            # fnmatch.translate-style class scan: a ']' (optionally after
            # the '!' negation) in first position is a literal member
            j = i + 1
            if j < len(pattern) and pattern[j] == "!":
                j += 1
            if j < len(pattern) and pattern[j] == "]":
                j += 1
            j = pattern.find("]", j)
            if j == -1:
                out.append(re.escape(ch))
            else:
                body = pattern[i + 1:j].replace("\\", "\\\\")
                if body.startswith("!"):
                    body = "^" + body[1:]
                out.append("[" + body + "]")
                i = j
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out) + r"\Z")


def list_keys(url: str) -> List[str]:
    """Expand an s3:// prefix or glob to object URLs (registry shard
    expansion; reference uses megfile.smart_glob)."""
    assert url.startswith("s3://"), url
    bucket, key = _split_s3(url)
    # prefix up to the first wildcard keeps pagination tight
    cut = len(key)
    for ch in "*?[":
        pos = key.find(ch)
        if pos != -1:
            cut = min(cut, pos)
    prefix = key[:cut]
    try:
        client = _s3_client()
    except ImportError:
        import fsspec

        creds = s3_credentials()
        fs = fsspec.filesystem(
            "s3", key=creds["aws_access_key_id"],
            secret=creds["aws_secret_access_key"],
            client_kwargs={"endpoint_url": creds["endpoint_url"]}
            if creds["endpoint_url"] else {})
        return ["s3://" + p for p in sorted(fs.glob(f"{bucket}/{key}"))]
    keys: List[str] = []
    token = None
    rx = _glob_re(key) if cut < len(key) else None
    while True:
        kw = {"Bucket": bucket, "Prefix": prefix}
        if token:
            kw["ContinuationToken"] = token
        resp = client.list_objects_v2(**kw)
        for item in resp.get("Contents", []):
            if rx is None and item["Key"] != key:
                continue  # exact-key listing
            if rx is not None and not rx.match(item["Key"]):
                continue
            keys.append(f"s3://{bucket}/{item['Key']}")
        if not resp.get("IsTruncated"):
            break
        token = resp.get("NextContinuationToken")
    return sorted(keys)
