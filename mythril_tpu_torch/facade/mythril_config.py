"""Configuration facade: ~/.mythril_tpu_torch dir, config.ini, RPC setup.

Reference parity: mythril/mythril/mythril_config.py:17-194.
"""

from __future__ import annotations

import configparser
import logging
import os
from pathlib import Path
from typing import Optional

from mythril_tpu_torch.exceptions import CriticalError
from mythril_tpu_torch.frontend.rpc import EthJsonRpc

log = logging.getLogger(__name__)


class MythrilConfig:
    def __init__(self):
        self.infura_id: Optional[str] = os.getenv("INFURA_ID")
        self.mythril_dir = self._init_mythril_dir()
        self.config_path = os.path.join(self.mythril_dir, "config.ini")
        self._init_config()
        self.eth: Optional[EthJsonRpc] = None

    @staticmethod
    def _init_mythril_dir() -> str:
        mythril_dir = os.environ.get(
            "MYTHRIL_DIR", os.path.join(str(Path.home()), ".mythril_tpu_torch")
        )
        os.makedirs(mythril_dir, exist_ok=True)
        return mythril_dir

    def _init_config(self) -> None:
        if not os.path.exists(self.config_path):
            config = configparser.ConfigParser()
            config.add_section("defaults")
            config.set("defaults", "dynamic_loading", "infura")
            with open(self.config_path, "w") as f:
                config.write(f)

    def set_api_from_config_path(self) -> None:
        config = configparser.ConfigParser()
        config.read(self.config_path)
        if config.has_option("defaults", "rpc"):
            self.set_api_rpc(config.get("defaults", "rpc"))

    def set_api_rpc_infura(self, network: str = "mainnet") -> None:
        if self.infura_id is None:
            raise CriticalError("set INFURA_ID environment variable to use Infura")
        self.eth = EthJsonRpc(
            f"https://{network}.infura.io/v3/{self.infura_id}", 443, True
        )

    def set_api_rpc(self, rpc: Optional[str] = None, rpctls: bool = False) -> None:
        if rpc == "ganache":
            rpc = "localhost:8545"
        if rpc and rpc.startswith("infura-"):
            self.set_api_rpc_infura(rpc[len("infura-") :])
            return
        if rpc:
            if ":" in rpc and not rpc.startswith("http"):
                host, port = rpc.rsplit(":", 1)
                self.eth = EthJsonRpc(host, int(port), rpctls)
            else:
                self.eth = EthJsonRpc(rpc, 8545, rpctls)
        else:
            self.eth = EthJsonRpc("localhost", 8545, rpctls)
        log.info("using RPC backend %s", self.eth.endpoint)
