"""Self-signed TLS bootstrap (reference: src/ssl_utils.py).

Generates a cert/key pair with openssl on first start and hardens file
permissions; no-op when both files already exist.
"""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)

DEFAULT_CERT_DIR = os.path.join(
    os.environ.get("XDG_DATA_HOME", os.path.expanduser("~/.local/share")),
    "open-speech",
)
DEFAULT_CERT_FILE = os.path.join(DEFAULT_CERT_DIR, "cert.pem")
DEFAULT_KEY_FILE = os.path.join(DEFAULT_CERT_DIR, "key.pem")


def ensure_ssl_certs(cert_file: str, key_file: str) -> None:
    cert, key = Path(cert_file), Path(key_file)
    if cert.exists() and key.exists():
        return
    cert.parent.mkdir(parents=True, exist_ok=True)
    key.parent.mkdir(parents=True, exist_ok=True)
    logger.info("Generating self-signed certificate at %s", cert_file)
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", str(key), "-out", str(cert),
            "-days", "3650", "-nodes",
            "-subj", "/CN=open-speech",
            "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
        ],
        check=True,
        capture_output=True,
    )
    os.chmod(key, 0o600)
    os.chmod(cert, 0o644)
