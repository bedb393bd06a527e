"""Dependency-free S3 REST client (SigV4) — stdlib http.client only (a copy
of ``merlin_tpu/data/s3http.py``).

The reference's data path is S3-native (base_dataset.py:33-75 reads every
shard through boto3/megfile), but boto3/s3fs are not installable on every
host image. This client implements the two S3 operations the data
path needs — GetObject (streaming, optional Range) and ListObjectsV2
(paginated) — with real AWS Signature Version 4 signing, so
``data/storage.py`` keeps working against any S3-compatible store with
nothing but the standard library.

Call shapes mirror boto3 (``get_object(Bucket=, Key=)`` returning
``{"Body": file-like}``; ``list_objects_v2`` returning
Contents/IsTruncated/NextContinuationToken) so the storage adapter uses
either client interchangeably. Wire-tested against a loopback server
that independently re-derives the SigV4 signature
(tests/test_storage.py, tests/test_torch_storage.py)."""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
_ALGO = "AWS4-HMAC-SHA256"


def _uri_encode(s: str, *, encode_slash: bool) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_signature(secret_key: str, date: str, region: str, service: str,
                    string_to_sign: str) -> str:
    """The AWS SigV4 HMAC chain (exposed so the loopback test server can
    re-derive signatures with the known secret)."""
    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    return hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()


def canonical_request(method: str, path: str, query: Dict[str, str],
                      headers: Dict[str, str], signed_headers: List[str],
                      payload_hash: str) -> str:
    """Canonical request per the SigV4 spec. ``path`` is the raw (decoded)
    object path; each segment is URI-encoded once, '/' preserved."""
    cqs = "&".join(
        f"{_uri_encode(k, encode_slash=True)}="
        f"{_uri_encode(v, encode_slash=True)}"
        for k, v in sorted(query.items()))
    lower = {k.lower(): " ".join(v.split()) for k, v in headers.items()}
    names = sorted(h.lower() for h in signed_headers)
    canon_headers = "".join(f"{h}:{lower[h]}\n" for h in names)
    return "\n".join([
        method, _uri_encode(path, encode_slash=False), cqs,
        canon_headers, ";".join(names), payload_hash])


class S3HttpClient:
    """Minimal boto3-shaped S3 client over stdlib HTTP with SigV4."""

    def __init__(self, access_key: str, secret_key: str,
                 session_token: Optional[str] = None,
                 endpoint_url: Optional[str] = None,
                 region: str = "us-east-1", timeout: float = 60.0):
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.region = region
        self.timeout = timeout
        if not endpoint_url:
            endpoint_url = f"https://s3.{region}.amazonaws.com"
        u = urllib.parse.urlsplit(endpoint_url)
        self._https = u.scheme == "https"
        self._host = u.netloc  # includes :port when non-default
        self._base_path = u.path.rstrip("/")

    # -- signing ---------------------------------------------------------

    def _signed_headers(self, method: str, path: str,
                        query: Dict[str, str],
                        extra: Optional[Dict[str, str]] = None
                        ) -> Dict[str, str]:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date = amz_date[:8]
        headers = {"host": self._host,
                   "x-amz-content-sha256": _EMPTY_SHA256,
                   "x-amz-date": amz_date}
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        if extra:
            headers.update({k.lower(): v for k, v in extra.items()})
        signed = sorted(headers)
        creq = canonical_request(method, path, query, headers, signed,
                                 _EMPTY_SHA256)
        scope = f"{date}/{self.region}/s3/aws4_request"
        sts = "\n".join([_ALGO, amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        sig = sigv4_signature(self.secret_key, date, self.region, "s3", sts)
        headers["authorization"] = (
            f"{_ALGO} Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
        return headers

    def _request(self, method: str, path: str, query: Dict[str, str],
                 extra_headers: Optional[Dict[str, str]] = None):
        conn_cls = (http.client.HTTPSConnection if self._https
                    else http.client.HTTPConnection)
        conn = conn_cls(self._host, timeout=self.timeout)
        headers = self._signed_headers(method, path, query, extra_headers)
        qs = urllib.parse.urlencode(sorted(query.items()))
        url = _uri_encode(path, encode_slash=False) + ("?" + qs if qs else "")
        conn.request(method, url, headers=headers)
        resp = conn.getresponse()
        if resp.status not in (200, 206):
            body = resp.read(4096)
            conn.close()
            raise OSError(
                f"S3 {method} {path!r} -> HTTP {resp.status}: "
                f"{body.decode(errors='replace')[:500]}")
        resp._s3_conn = conn  # keep the connection alive with the body
        return resp

    # -- boto3-shaped operations ------------------------------------------

    def get_object(self, Bucket: str, Key: str,
                   Range: Optional[str] = None) -> dict:
        extra = {"range": Range} if Range else None
        resp = self._request("GET", f"{self._base_path}/{Bucket}/{Key}",
                             {}, extra)
        out = {"Body": _HttpBody(resp)}
        length = resp.getheader("Content-Length")
        if length is not None:
            out["ContentLength"] = int(length)
        return out

    def list_objects_v2(self, Bucket: str, Prefix: str = "",
                        ContinuationToken: Optional[str] = None,
                        MaxKeys: Optional[int] = None) -> dict:
        query = {"list-type": "2", "prefix": Prefix}
        if ContinuationToken:
            query["continuation-token"] = ContinuationToken
        if MaxKeys:
            query["max-keys"] = str(MaxKeys)
        resp = self._request("GET", f"{self._base_path}/{Bucket}", query)
        data = resp.read()
        resp._s3_conn.close()
        root = ET.fromstring(data)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[:root.tag.index("}") + 1]
        out = {"Contents": [], "IsTruncated": False}
        for item in root.findall(f"{ns}Contents"):
            entry = {"Key": item.findtext(f"{ns}Key")}
            size = item.findtext(f"{ns}Size")
            if size is not None:
                entry["Size"] = int(size)
            out["Contents"].append(entry)
        if (root.findtext(f"{ns}IsTruncated") or "").lower() == "true":
            out["IsTruncated"] = True
            token = root.findtext(f"{ns}NextContinuationToken")
            if token:
                out["NextContinuationToken"] = token
        return out


class _HttpBody:
    """http.client response as a boto3 StreamingBody: sequential read()
    then close() (closes the underlying connection too)."""

    def __init__(self, resp):
        self._resp = resp

    def read(self, n: int = -1) -> bytes:
        return self._resp.read(None if n is None or n < 0 else n)

    def close(self):
        try:
            self._resp.close()
        finally:
            conn = getattr(self._resp, "_s3_conn", None)
            if conn is not None:
                conn.close()
