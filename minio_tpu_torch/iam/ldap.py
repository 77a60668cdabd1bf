"""Minimal LDAP v3 simple-bind client for STS AssumeRoleWithLDAPIdentity,
the port of minio_tpu/iam/ldap.py (reference cmd/config/identity/ldap/:
the reference validates the user's password with a simple bind and may map
groups; this client does the bind over raw BER on a socket, with no LDAP
library).

Only the operations STS needs: open, BindRequest with DN and password,
read the BindResponse, close. Any non-zero resultCode (49 =
invalidCredentials) fails the exchange."""
from __future__ import annotations

import socket


def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(out)]) + out


def _ber(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(content)) + content


def _ber_int(v: int) -> bytes:
    out = v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big", signed=True)
    return _ber(0x02, out)


def _read_ber(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _recv_exact(sock, 2)
    tag, l0 = hdr[0], hdr[1]
    if l0 < 0x80:
        length = l0
    else:
        nlen = l0 & 0x7F
        length = int.from_bytes(_recv_exact(sock, nlen), "big")
    return tag, _recv_exact(sock, length)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("ldap connection closed")
        buf += chunk
    return buf


class LDAPError(RuntimeError):
    def __init__(self, code: int, message: str = ""):
        self.code = code
        super().__init__(f"ldap result {code}: {message}")


def simple_bind(server: str, dn: str, password: str,
                timeout_s: float = 5.0) -> None:
    """One LDAPv3 simple bind; raises LDAPError/OSError on failure,
    returns on resultCode success(0). ``server``: host[:port]."""
    host, _, port = server.partition(":")
    with socket.create_connection((host, int(port or 389)),
                                  timeout_s) as s:
        s.settimeout(timeout_s)
        bind = _ber(0x60,                        # [APPLICATION 0] Bind
                    _ber_int(3)                  # version 3
                    + _ber(0x04, dn.encode())    # bind DN
                    + _ber(0x80, password.encode()))  # simple auth
        msg = _ber(0x30, _ber_int(1) + bind)     # messageID 1
        s.sendall(msg)
        tag, body = _read_ber(s)                 # LDAPMessage SEQUENCE
        if tag != 0x30:
            raise LDAPError(-1, f"unexpected tag {tag:#x}")
        # skip messageID
        if body[0] != 0x02:
            raise LDAPError(-1, "missing messageID")
        idlen = body[1]
        rest = body[2 + idlen:]
        if not rest or rest[0] != 0x61:          # BindResponse
            raise LDAPError(-1, "not a BindResponse")
        # parse into the response content
        off = 2 if rest[1] < 0x80 else 2 + (rest[1] & 0x7F)
        resp = rest[off:]
        if resp[0] != 0x0A:                      # ENUMERATED resultCode
            raise LDAPError(-1, "missing resultCode")
        code = int.from_bytes(resp[2:2 + resp[1]], "big")
        if code != 0:
            raise LDAPError(code, "bind failed")
