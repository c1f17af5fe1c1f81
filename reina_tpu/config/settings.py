"""Deployment settings from environment / .env file
(reference: common/settings.py)."""
from __future__ import annotations

import os


def _load_dotenv() -> None:
    path = os.path.join(os.getcwd(), ".env")
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, _, v = line.partition("=")
            os.environ.setdefault(k.strip(), v.strip().strip('"').strip("'"))


_load_dotenv()

CACHE_TYPE = os.environ.get(
    "REINA_CACHE", "redis" if os.environ.get("REDIS_URL") else "memory")
REDIS_URL = os.environ.get("REDIS_URL")
SECRET_KEY = os.environ.get("SECRET_KEY", "reina-dev-secret")
URL_PREFIX = os.environ.get("URL_PREFIX", "")
BASE_URL = os.environ.get("BASE_URL", "http://localhost:5000")
PORT = int(os.environ.get("PORT", "5000"))
TRAFFIC_WARNING = bool(int(os.environ.get("TRAFFIC_WARNING", "0")))
RESTRICT_TO_PRESET_SCENARIOS = bool(
    int(os.environ.get("RESTRICT_TO_PRESET_SCENARIOS", "0")))
VARIABLE_OVERRIDE_SET = os.environ.get("VARIABLE_OVERRIDE_SET")
MAX_CONCURRENT_RUNS = int(os.environ.get("MAX_CONCURRENT_RUNS", "16"))
# Origins allowed credentialed cross-origin API access (comma-separated;
# e.g. the reina-ui deployment). Unlisted origins get the reference's
# flask-cors default: '*' without credentials.
CORS_ORIGINS = [o.strip() for o in
                os.environ.get("CORS_ORIGINS", "").split(",") if o.strip()]
