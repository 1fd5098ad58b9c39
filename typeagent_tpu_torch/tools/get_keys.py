"""Sync developer API keys between an Azure Key Vault and a local ``.env``.

(Parity role: reference ``tools/get_keys.py`` — pull the team's shared
provider keys from a Key Vault into ``.env``, or push local edits back up.)
Implemented over the Key Vault REST API (the standard library's
``http.client``, ``tools/rest.py``) with a bearer token from the ``az``
CLI, instead of azure-identity/azure-mgmt SDKs:

  * token: ``AZURE_KEYVAULT_TOKEN`` env var if set, else
    ``az account get-access-token --resource https://vault.azure.net``;
  * secrets: ``GET/PUT https://<vault>.vault.azure.net/secrets/...``
    (api-version 7.4), paged listing via ``nextLink``.

Key Vault secret names cannot contain underscores, so ``ENV_VAR`` names map
to ``ENV-VAR`` secret names and back (same convention as the reference,
``tools/get_keys.py:446-453``). Which env vars sync is driven by a JSON
config (``get_keys.config.json`` next to this file, or ``--config``):

    {"defaultDotEnvPath": "../../.env",
     "env": {"shared": ["OPENAI_API_KEY", ...], "private": [], "delete": []},
     "vault": {"shared": "my-team-vault"}}

Vault names resolve from ``--vault``/``--private`` flags, then the
``TYPEAGENT_SHAREDVAULT``/``TYPEAGENT_PRIVATEVAULT`` entries of the
``.env`` itself, then the config; ``pull`` persists the resolved names back
into ``.env``. The reference's Azure-PIM auto-elevation is intentionally out
of scope (Microsoft-tenant-internal); a 403 prints the role you need.

The port of ``typeagent_tpu/tools/get_keys.py`` (which uses httpx); it
touches no device. Pass ``KeyVaultClient(client=RestClient(connect_to=
...))`` to send every request to another address (a test's loopback fake).

Run: ``python -m typeagent_tpu_torch.tools.get_keys pull`` (or ``push``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from .rest import Response, RestClient

VAULT_RESOURCE = "https://vault.azure.net"
API_VERSION = "7.4"
_DEFAULT_CONFIG = Path(__file__).parent / "get_keys.config.json"


def to_secret_name(env_key: str) -> str:
    """Key Vault secret names allow dashes, not underscores."""
    return env_key.replace("_", "-")


def to_env_key(secret_name: str) -> str:
    return secret_name.replace("-", "_")


def az_cli_token(resource: str = VAULT_RESOURCE) -> str:
    """Bearer token for Key Vault from the logged-in ``az`` CLI."""
    override = os.environ.get("AZURE_KEYVAULT_TOKEN")
    if override:
        return override
    try:
        proc = subprocess.run(
            ["az", "account", "get-access-token", "--resource", resource,
             "--output", "json"],
            capture_output=True, text=True, check=True,
        )
    except FileNotFoundError:
        raise SystemExit(
            "Azure CLI not found. Install it and run 'az login', or set "
            "AZURE_KEYVAULT_TOKEN."
        )
    except subprocess.CalledProcessError as exc:
        raise SystemExit(
            f"'az account get-access-token' failed (run 'az login'?):\n"
            f"{exc.stderr.strip()}"
        )
    return json.loads(proc.stdout)["accessToken"]


class KeyVaultClient:
    """Minimal Key Vault secrets client over REST."""

    def __init__(self, token: str | None = None, client: RestClient | None = None):
        self._token = token if token is not None else az_cli_token()
        self._client = client or RestClient(timeout=30.0)

    def _request(self, method: str, url: str, **kwargs) -> Response:
        resp = self._client.request(
            method, url,
            headers={"Authorization": f"Bearer {self._token}"},
            params={"api-version": API_VERSION, **kwargs.pop("params", {})},
            **kwargs,
        )
        if resp.status_code == 403:
            raise SystemExit(
                f"403 from {url}: you need the 'Key Vault Secrets "
                f"{'Officer' if method == 'PUT' else 'User'}' role on this "
                "vault (elevate in the Azure portal, then retry)."
            )
        resp.raise_for_status()
        return resp

    def list_secret_names(self, vault: str) -> list[str]:
        names: list[str] = []
        url: str | None = f"https://{vault}.vault.azure.net/secrets"
        while url:
            page = self._request("GET", url).json()
            names += [item["id"].rsplit("/", 1)[-1] for item in page.get("value", [])]
            url = page.get("nextLink")
        return names

    def read_secret(self, vault: str, name: str) -> str:
        url = f"https://{vault}.vault.azure.net/secrets/{name}"
        return self._request("GET", url).json()["value"]

    def write_secret(self, vault: str, name: str, value: str) -> None:
        url = f"https://{vault}.vault.azure.net/secrets/{name}"
        self._request("PUT", url, json={"value": value})


# --- .env handling ---------------------------------------------------------
# The file is kept line-oriented: comments/blank lines survive a pull, and
# updated keys rewrite in place. New keys append at the end.


def read_dotenv_lines(path: Path) -> list[str]:
    if not path.exists():
        return []
    return path.read_text().splitlines()


def dotenv_values(lines: list[str]) -> dict[str, str]:
    values: dict[str, str] = {}
    for line in lines:
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or "=" not in stripped:
            continue
        key, _, value = stripped.partition("=")
        key = key.strip()
        if "-" in key:
            raise SystemExit(
                f"dotenv key {key!r} contains a dash; Key Vault mapping "
                "(underscore<->dash) would be ambiguous."
            )
        values[key] = value
    return values


def apply_updates(
    lines: list[str], updates: dict[str, str], deletes: set[str]
) -> list[str]:
    out: list[str] = []
    rewritten: set[str] = set()
    for line in lines:
        stripped = line.strip()
        if stripped and not stripped.startswith("#") and "=" in stripped:
            key = stripped.partition("=")[0].strip()
            if key in deletes:
                continue
            if key in updates:
                # Rewrite EVERY occurrence: a later duplicate line wins on
                # reload, so leaving it stale would undo the update.
                out.append(f"{key}={updates[key]}")
                rewritten.add(key)
                continue
        out.append(line)
    out += [f"{k}={v}" for k, v in updates.items() if k not in rewritten]
    return out


# --- pull / push ------------------------------------------------------------


class Config:
    def __init__(self, path: Path):
        raw = json.loads(path.read_text())
        self.dotenv_path = (path.parent / raw["defaultDotEnvPath"]).resolve()
        env = raw.get("env", {})
        self.shared_keys: list[str] = env.get("shared", [])
        self.private_keys: list[str] = env.get("private", [])
        self.delete_keys: list[str] = env.get("delete", [])
        self.shared_vault: str | None = raw.get("vault", {}).get("shared")


def resolve_vaults(
    args: argparse.Namespace, cfg: Config, env_values: dict[str, str]
) -> dict[str, str | None]:
    return {
        "shared": args.vault
        or env_values.get("TYPEAGENT_SHAREDVAULT")
        or cfg.shared_vault,
        "private": args.private or env_values.get("TYPEAGENT_PRIVATEVAULT"),
    }


def pull(client: KeyVaultClient, cfg: Config, args: argparse.Namespace) -> int:
    """Vault -> .env. Returns the number of keys changed."""
    dotenv_path = Path(args.dotenv) if args.dotenv else cfg.dotenv_path
    lines = read_dotenv_lines(dotenv_path)
    current = dotenv_values(lines)
    vaults = resolve_vaults(args, cfg, current)
    if not vaults["shared"]:
        raise SystemExit("No shared vault configured (--vault / config / .env).")

    updates: dict[str, str] = {}
    found_any = False
    for scope, wanted in (("shared", cfg.shared_keys), ("private", cfg.private_keys)):
        vault = vaults[scope]
        if not vault:
            continue
        wanted_set = set(wanted)
        names = client.list_secret_names(vault)
        found_any = found_any or bool(names)
        for name in names:
            env_key = to_env_key(name)
            if env_key not in wanted_set:
                continue
            value = client.read_secret(vault, name)
            if current.get(env_key) != value:
                print(f"  updating {env_key} ([REDACTED])")
                updates[env_key] = value
    if not found_any:
        raise SystemExit("No secrets found in the configured vault(s).")

    deletes = {key for key in cfg.delete_keys if key in current}
    for key in deletes:
        print(f"  deleting {key}")
    for var, scope in (("TYPEAGENT_SHAREDVAULT", "shared"),
                       ("TYPEAGENT_PRIVATEVAULT", "private")):
        if vaults[scope] and current.get(var) != vaults[scope]:
            updates[var] = vaults[scope]  # persist for the next run

    changed = len(updates) + len(deletes)
    if changed:
        dotenv_path.write_text("\n".join(apply_updates(lines, updates, deletes)) + "\n")
        print(f"{changed} keys updated in {dotenv_path}")
    else:
        print(f"all keys up to date in {dotenv_path}")
    return changed


def push(client: KeyVaultClient, cfg: Config, args: argparse.Namespace) -> int:
    """.env -> vault. Returns the number of secrets written."""
    dotenv_path = Path(args.dotenv) if args.dotenv else cfg.dotenv_path
    current = dotenv_values(read_dotenv_lines(dotenv_path))
    vaults = resolve_vaults(args, cfg, current)
    if not vaults["shared"]:
        raise SystemExit("No shared vault configured (--vault / config / .env).")

    written = 0
    for scope, wanted in (("shared", cfg.shared_keys), ("private", cfg.private_keys)):
        vault = vaults[scope]
        if not vault:
            continue
        wanted_names = {to_secret_name(key) for key in wanted}
        # Read only the configured secrets — the vault may hold many
        # unrelated ones (and reads of those may not even be permitted).
        remote = {
            name: client.read_secret(vault, name)
            for name in client.list_secret_names(vault)
            if name in wanted_names
        }
        for env_key in wanted:
            if env_key not in current:
                continue
            name = to_secret_name(env_key)
            value = current[env_key]
            if remote.get(name) == value:
                continue
            if name in remote and not args.yes:
                answer = input(f"  overwrite {name} ([REDACTED])? [y/N] ")
                if answer.strip().lower() != "y":
                    print("  skipped")
                    continue
            print(f"  {'overwriting' if name in remote else 'creating'} {name}")
            client.write_secret(vault, name, value)
            written += 1
    print(f"{written} secrets written")
    return written


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Sync API keys between Azure Key Vault and .env"
    )
    parser.add_argument("command", nargs="?", default="pull",
                        choices=["pull", "push"])
    parser.add_argument("--vault", help="shared vault name")
    parser.add_argument("--private", help="private vault name")
    parser.add_argument("--dotenv", help=".env path (default: from config)")
    parser.add_argument("--config", help="config JSON path",
                        default=str(_DEFAULT_CONFIG))
    parser.add_argument("--yes", "-y", action="store_true",
                        help="overwrite changed secrets on push without asking")
    args = parser.parse_args(argv)

    cfg = Config(Path(args.config))
    client = KeyVaultClient()
    if args.command == "pull":
        pull(client, cfg, args)
    else:
        push(client, cfg, args)


if __name__ == "__main__":
    sys.exit(main())
