"""External authentication: OIDC id-token login and LDAP-style directory bind.

The torch port's copy of ``simpletuner_tpu/server/external_auth.py``: the same behavior.

Reference behavior: simpletuner_sdk/server/routes/external_auth (SURVEY.md
§2.7 "users/orgs/quotas/approvals/audit/auth/external_auth (LDAP/OIDC)"):
the platform can delegate identity to an OIDC issuer or an LDAP directory,
auto-provisioning local users on first login.

* **OIDC**: stdlib JWT verification — HS256 via ``hmac`` with a shared
  secret, RS256 via ``cryptography`` against a local JWKS file (zero-egress
  environment: the JWKS must be provisioned on disk, not fetched).  Claims
  checked: signature, ``exp``, ``iss``, ``aud``.
* **Directory bind**: a file-backed directory (salted-SHA256 passwords,
  group lists) with LDAP-equivalent bind semantics; a real ``ldap3``-backed
  provider is selected automatically when the library is installed, and
  raises an honest error naming the missing dependency otherwise (fail-loud,
  no silent substitution).

Group→role mapping: any group listed in ``admin_groups`` grants the local
``admin`` role; everyone else provisions as ``user``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import time
from typing import Any, Dict, List, Optional


class ExternalAuthError(Exception):
    pass


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


# ---- OIDC -------------------------------------------------------------------------------


class OIDCVerifier:
    """Verifies OIDC id_tokens offline.

    config keys: issuer, audience, hs256_secret (HS256) or jwks_path (RS256),
    admin_groups (list), username_claim (default preferred_username→sub).
    """

    def __init__(self, config: Dict[str, Any]):
        self.issuer = str(config.get("issuer") or "")
        self.audience = str(config.get("audience") or "")
        self.hs256_secret = config.get("hs256_secret")
        self.jwks_path = config.get("jwks_path")
        self.admin_groups = set(config.get("admin_groups") or [])
        self.username_claim = config.get("username_claim") or "preferred_username"
        if not self.issuer or not self.audience:
            raise ExternalAuthError("OIDC config requires issuer and audience")
        if not self.hs256_secret and not self.jwks_path:
            raise ExternalAuthError("OIDC config requires hs256_secret or jwks_path")

    def verify(self, id_token: str) -> Dict[str, Any]:
        try:
            header_b64, payload_b64, sig_b64 = id_token.split(".")
            header = json.loads(_b64url_decode(header_b64))
            payload = json.loads(_b64url_decode(payload_b64))
            signature = _b64url_decode(sig_b64)
        except (ValueError, json.JSONDecodeError) as exc:
            raise ExternalAuthError(f"malformed id_token: {exc}") from exc
        signing_input = f"{header_b64}.{payload_b64}".encode()
        alg = header.get("alg")
        if alg == "HS256":
            if not self.hs256_secret:
                raise ExternalAuthError("token is HS256 but no hs256_secret configured")
            expected = hmac.new(
                str(self.hs256_secret).encode(), signing_input, hashlib.sha256
            ).digest()
            if not hmac.compare_digest(expected, signature):
                raise ExternalAuthError("bad HS256 signature")
        elif alg == "RS256":
            self._verify_rs256(header, signing_input, signature)
        else:
            raise ExternalAuthError(f"unsupported JWT alg {alg!r} (HS256/RS256)")
        now = time.time()
        if float(payload.get("exp", 0)) < now:
            raise ExternalAuthError("id_token expired")
        if payload.get("iss") != self.issuer:
            raise ExternalAuthError(
                f"issuer mismatch: {payload.get('iss')!r} != {self.issuer!r}"
            )
        aud = payload.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if self.audience not in auds:
            raise ExternalAuthError(f"audience mismatch: {aud!r}")
        return payload

    def _verify_rs256(self, header: Dict[str, Any], signing_input: bytes,
                      signature: bytes) -> None:
        if not self.jwks_path:
            raise ExternalAuthError("token is RS256 but no jwks_path configured")
        try:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives import hashes
            from cryptography.hazmat.primitives.asymmetric import padding, rsa
        except ImportError as exc:  # pragma: no cover
            raise ExternalAuthError(
                "RS256 verification requires the 'cryptography' package"
            ) from exc
        with open(self.jwks_path) as fh:
            jwks = json.load(fh)
        kid = header.get("kid")
        keys = [k for k in jwks.get("keys", []) if kid is None or k.get("kid") == kid]
        if not keys:
            raise ExternalAuthError(f"no JWKS key matches kid={kid!r}")
        for key in keys:
            n = int.from_bytes(_b64url_decode(key["n"]), "big")
            e = int.from_bytes(_b64url_decode(key["e"]), "big")
            public = rsa.RSAPublicNumbers(e, n).public_key()
            try:
                public.verify(signature, signing_input, padding.PKCS1v15(), hashes.SHA256())
                return
            except InvalidSignature:
                continue
        raise ExternalAuthError("bad RS256 signature")

    def identity(self, claims: Dict[str, Any]) -> Dict[str, Any]:
        username = claims.get(self.username_claim) or claims.get("sub")
        if not username:
            raise ExternalAuthError(
                f"id_token carries neither {self.username_claim!r} nor 'sub'"
            )
        groups = set(claims.get("groups") or [])
        return {
            "username": str(username),
            "email": claims.get("email"),
            "role": "admin" if groups & self.admin_groups else "user",
            "groups": sorted(groups),
        }


def make_hs256_token(claims: Dict[str, Any], secret: str) -> str:
    """Mint an HS256 JWT (used by tests and the CLI's token helper)."""
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url_encode(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{header}.{payload}".encode(), hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url_encode(sig)}"


# ---- directory (LDAP-style) bind --------------------------------------------------------


class FileDirectory:
    """File-backed directory with LDAP bind semantics.

    directory.json: {username: {password: "salt$sha256hex", groups: [...],
    email}}.  Passwords are salted SHA-256; ``set_password`` writes,
    ``bind`` verifies.
    """

    def __init__(self, path: str):
        self.path = path
        self._entries: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(path):
            with open(path) as fh:
                self._entries = json.load(fh)

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._entries, fh, indent=2)
        os.replace(tmp, self.path)

    @staticmethod
    def _hash(password: str, salt: str) -> str:
        return hashlib.sha256((salt + password).encode()).hexdigest()

    def set_password(self, username: str, password: str,
                     groups: Optional[List[str]] = None,
                     email: Optional[str] = None) -> None:
        salt = secrets.token_hex(8)
        entry = self._entries.setdefault(username, {})
        entry["password"] = f"{salt}${self._hash(password, salt)}"
        if groups is not None:
            entry["groups"] = list(groups)
        if email is not None:
            entry["email"] = email
        self._flush()

    def bind(self, username: str, password: str) -> Dict[str, Any]:
        entry = self._entries.get(username)
        if entry is None:
            raise ExternalAuthError(f"no such directory entry {username!r}")
        salt, digest = entry["password"].split("$", 1)
        if not hmac.compare_digest(self._hash(password, salt), digest):
            raise ExternalAuthError("invalid credentials")
        return {
            "username": username,
            "email": entry.get("email"),
            "groups": list(entry.get("groups") or []),
        }


class LDAPDirectory:  # pragma: no cover - requires ldap3 + a live server
    """Real LDAP bind via ``ldap3`` when installed; honest error otherwise."""

    def __init__(self, config: Dict[str, Any]):
        try:
            import ldap3  # noqa: F401
        except ImportError as exc:
            raise ExternalAuthError(
                "LDAP auth requires the 'ldap3' package, which is not installed "
                "in this environment; use directory_type=file with a provisioned "
                "directory.json instead"
            ) from exc
        self.config = config

    def bind(self, username: str, password: str) -> Dict[str, Any]:
        import ldap3

        server = ldap3.Server(self.config["server"], get_info=ldap3.NONE)
        dn = self.config["user_dn_template"].format(username=username)
        conn = ldap3.Connection(server, user=dn, password=password)
        if not conn.bind():
            raise ExternalAuthError("invalid credentials")
        groups: List[str] = []
        base = self.config.get("group_search_base")
        if base:
            conn.search(base, f"(member={dn})", attributes=["cn"])
            groups = [str(e.cn) for e in conn.entries]
        conn.unbind()
        return {"username": username, "email": None, "groups": groups}


class ExternalAuth:
    """Facade the server uses: loads ``external_auth.json`` from the state
    dir; exposes oidc_login / directory_login, each returning a provisioned
    identity {username, role, email, groups}."""

    def __init__(self, root: str):
        self.root = root
        self.config_path = os.path.join(root, "external_auth.json")
        self.config: Dict[str, Any] = {}
        if os.path.exists(self.config_path):
            with open(self.config_path) as fh:
                self.config = json.load(fh)

    def configure(self, config: Dict[str, Any]) -> None:
        if "oidc" in config:
            OIDCVerifier(config["oidc"])  # validate eagerly
        self.config = config
        tmp = self.config_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(config, fh, indent=2)
        os.replace(tmp, self.config_path)

    @property
    def oidc_enabled(self) -> bool:
        return "oidc" in self.config

    @property
    def directory_enabled(self) -> bool:
        return "directory" in self.config

    def oidc_login(self, id_token: str) -> Dict[str, Any]:
        if not self.oidc_enabled:
            raise ExternalAuthError("OIDC is not configured")
        verifier = OIDCVerifier(self.config["oidc"])
        return verifier.identity(verifier.verify(id_token))

    def directory_login(self, username: str, password: str) -> Dict[str, Any]:
        if not self.directory_enabled:
            raise ExternalAuthError("directory auth is not configured")
        cfg = self.config["directory"]
        kind = cfg.get("type", "file")
        if kind == "file":
            directory = FileDirectory(cfg.get("path") or os.path.join(self.root, "directory.json"))
        elif kind == "ldap":
            directory = LDAPDirectory(cfg)
        else:
            raise ExternalAuthError(f"unknown directory type {kind!r} (file|ldap)")
        identity = directory.bind(username, password)
        admin_groups = set(cfg.get("admin_groups") or [])
        identity["role"] = "admin" if set(identity["groups"]) & admin_groups else "user"
        return identity
