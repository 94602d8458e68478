"""Master entrypoint (ref ``cmd/GPUMounter-master/main.go:227-241``; the
port of :mod:`gpumounter_tpu.master.main`).

Run as: ``python -m gpumounter_tpu_torch.master.main``. The environment is
the control plane's. The master runs the single-master path; where the
environment asks for a plane that is not ported yet (``TPU_MASTER_SHARDS``
> 1, the election or the intent store, node health or the topology plane
not set to ``0``), it logs one WARNING naming the ROADMAP item and serves
as the control plane does with that plane off.
"""

from __future__ import annotations

import os
import time

from gpumounter_tpu_torch.k8s.client import default_kube_client
from gpumounter_tpu_torch.master.admission import AttachBroker, BrokerConfig
from gpumounter_tpu_torch.master.discovery import WorkerDirectory
from gpumounter_tpu_torch.master.gateway import MasterGateway
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.worker.grpc_server import (WorkerClient,
                                                     load_tls_config)

logger = get_logger("master.main")


def unported_planes(settings: Settings, env=None) -> list[str]:
    """The planes the environment asks for that the port's master does not
    run yet, each with its ROADMAP item."""
    env = os.environ if env is None else env
    asked = []
    if (settings.master_shards > 1 or settings.election_enabled
            or settings.intent_store_enabled):
        asked.append(f"HA ({consts.ENV_MASTER_SHARDS}="
                     f"{settings.master_shards}, election/intent store; "
                     "Queue 1 item 12b)")
    if env.get(consts.ENV_NODE_HEALTH, "1") != "0":
        asked.append(f"node health ({consts.ENV_NODE_HEALTH}; "
                     "Queue 1 item 12c)")
    if settings.topology_enabled:
        asked.append(f"topology and defrag ({consts.ENV_TOPOLOGY}; "
                     "Queue 1 item 12d)")
    return asked


def main() -> None:
    from gpumounter_tpu_torch.utils.log import init_logger
    init_logger()
    settings = Settings.from_env()
    kube = default_kube_client()
    directory = WorkerDirectory(kube,
                                namespace=settings.worker_namespace,
                                label_selector=settings.worker_label_selector,
                                grpc_port=settings.worker_grpc_port)
    tls = load_tls_config()
    # Attach broker: quotas/leases/queueing from TPU_QUOTAS,
    # TPU_LEASE_TTL_S, TPU_QUEUE_TIMEOUT_S (... all default-off). serve()
    # starts its lease-expiry loop.
    broker = AttachBroker(kube, BrokerConfig.from_settings(settings))
    asked = unported_planes(settings)
    if asked:
        logger.warning("not ported yet (ROADMAP): %s; the master serves "
                       "the single-master path with these planes off",
                       "; ".join(asked))
    gateway = MasterGateway(
        kube, directory,
        worker_client_factory=lambda target: WorkerClient(target, tls=tls),
        broker=broker)
    server = gateway.serve(settings.master_http_port)
    logger.info("master ready on :%d (quotas=%s lease_ttl=%gs queue=%gs)",
                settings.master_http_port, settings.tenant_quotas or "off",
                settings.lease_ttl_s, settings.queue_timeout_s)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
