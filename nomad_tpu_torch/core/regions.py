"""Multi-region federation (reference: nomad/regions.go + the WAN Serf
pool + rpcHandler.forward's region forwarding).

Regions are independent scheduling domains — each with its own servers,
Raft log, and state — federated only by a small push-pull address table:
every agent knows {region -> an HTTP base URL in that region}.  A request
carrying `?region=X` for a foreign X is proxied verbatim to that region's
agent (the HTTP analog of the reference's cross-region msgpack-RPC
forwarding; responses stream back unchanged).  Multiregion jobs fan out
per-region copies through the same table (the reference gates staged
multiregion deployments behind enterprise; the OSS-visible surface — the
`multiregion` stanza + per-region registration — is implemented here).

The table is gossiped lazily: `join(peer_url)` POSTs our table to the
peer's /v1/regions/federation and merges the reply, so joining any one
agent of any region eventually teaches both sides every region either
knows (push-pull, like the LAN gossip's member sync).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from .logging import log


class RegionFederation:
    """Per-agent region table + cross-region HTTP forwarding."""

    def __init__(self, region: str = "global") -> None:
        self.region = region
        self._lock = threading.Lock()
        self._urls: Dict[str, str] = {}

    # ------------------------------------------------------------- table

    def set_self_url(self, url: str) -> None:
        with self._lock:
            self._urls[self.region] = url.rstrip("/")

    def table(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._urls)

    def regions(self) -> List[str]:
        with self._lock:
            return sorted(self._urls)

    def url_for(self, region: str) -> Optional[str]:
        with self._lock:
            return self._urls.get(region)

    def merge(self, table: Dict[str, str]) -> None:
        """Adopt peer entries; NEVER let a peer overwrite our own region's
        address (a misconfigured peer must not hijack local forwarding).

        Plaintext federation URLs are adopted but LOUDLY flagged:
        cross-region forwarding carries the caller's ACL token, job
        bodies, and variable contents, and the cluster's wire encryption
        covers only raft/serf/rpc — over an untrusted WAN these must ride
        https (reference posture: TLS-only cross-region RPC)."""
        with self._lock:
            for region, url in (table or {}).items():
                if region == self.region:
                    continue
                if isinstance(region, str) and isinstance(url, str):
                    if url.startswith("http://"):
                        log("regions", "warn",
                            "PLAINTEXT federation URL adopted — "
                            "cross-region requests (including ACL "
                            "tokens and variable contents) will be "
                            "unencrypted on the WAN; use https",
                            region=region, url=url)
                    self._urls[region] = url.rstrip("/")

    # -------------------------------------------------------------- join

    def join(self, peer_url: str, timeout: float = 5.0,
             token: str = "") -> bool:
        """Push-pull federation sync with any agent of any region.
        `token`: a management token for the PEER — required when the
        peer runs with ACLs (its federation-table writes are
        management-gated)."""
        peer_url = peer_url.rstrip("/")
        body = json.dumps({"Regions": self.table()}).encode()
        req = urllib.request.Request(
            peer_url + "/v1/regions/federation", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        if token:
            req.add_header("X-Nomad-Token", token)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = json.loads(resp.read().decode() or "{}")
        except (OSError, ValueError, urllib.error.URLError) as e:
            # error, not warn: an agent started with -join-wan that never
            # federates serves 404s for every foreign ?region= request
            log("regions", "error", "federation join FAILED — foreign "
                "regions will be unreachable (ACL peers need "
                "-join-wan-token)", peer=peer_url, error=str(e))
            return False
        self.merge(data.get("Regions", {}))
        return True

    # ----------------------------------------------------------- forward

    def forward(self, region: str, method: str, path: str, qs: str,
                body: Optional[bytes], token: str = "",
                timeout: float = 35.0) -> Tuple[int, bytes]:
        """Proxy one API request to `region`'s agent; returns
        (status, response bytes).  The `region` query param is stripped
        upstream so the target serves it as a local request."""
        base = self.url_for(region)
        if base is None:
            return 404, json.dumps(
                {"error": f"unknown region {region!r}"}).encode()
        url = base + path + (("?" + qs) if qs else "")
        req = urllib.request.Request(url, data=body, method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if token:
            req.add_header("X-Nomad-Token", token)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (OSError, urllib.error.URLError) as e:
            return 502, json.dumps(
                {"error": f"region {region!r} unreachable: {e}"}).encode()
