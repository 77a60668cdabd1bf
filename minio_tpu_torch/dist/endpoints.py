"""Endpoint parsing and node topology, the port of
minio_tpu/dist/endpoints.py (reference cmd/endpoint.go): each
endpoint is either a local path or ``http://host:port/path``; endpoints
grouped by node, local ones detected by matching this node's advertised
URL."""
from __future__ import annotations

import urllib.parse
from dataclasses import dataclass


@dataclass(frozen=True)
class Endpoint:
    url: str        # "" for pure-local path endpoints
    path: str

    @property
    def is_local_path(self) -> bool:
        return self.url == ""

    def node(self) -> str:
        return self.url

    def __str__(self):
        return f"{self.url}{self.path}" if self.url else self.path


def parse_endpoint(arg: str) -> Endpoint:
    if arg.startswith(("http://", "https://")):
        u = urllib.parse.urlsplit(arg)
        if not u.path or u.path == "/":
            raise ValueError(f"endpoint {arg!r} missing a disk path")
        return Endpoint(url=f"{u.scheme}://{u.netloc}", path=u.path)
    return Endpoint(url="", path=arg)


def parse_endpoints(args: list[str]) -> list[Endpoint]:
    from .ellipses import expand_endpoints
    eps = [parse_endpoint(a) for a in expand_endpoints(args)]
    kinds = {e.is_local_path for e in eps}
    if len(kinds) > 1:
        raise ValueError("cannot mix URL and path endpoints")
    return eps


def nodes_of(endpoints: list[Endpoint]) -> list[str]:
    seen = []
    for e in endpoints:
        if e.url and e.url not in seen:
            seen.append(e.url)
    return seen
