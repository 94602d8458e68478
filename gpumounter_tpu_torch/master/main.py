"""Master entrypoint (ref ``cmd/GPUMounter-master/main.go:227-241``; the
port of :mod:`gpumounter_tpu.master.main`).

Run as: ``python -m gpumounter_tpu_torch.master.main``. The environment is
the control plane's, the HA plane included (``TPU_MASTER_SHARDS``,
``TPU_ELECTION``, ``TPU_INTENT_STORE``, ...; all off by default), node
health (``TPU_NODE_HEALTH``), the topology plane (``TPU_TOPOLOGY``) and
the defragmenter (``TPU_DEFRAG_MODE``, ``plan`` by default), each on by
default.
"""

from __future__ import annotations

import time

from gpumounter_tpu_torch.k8s.client import default_kube_client
from gpumounter_tpu_torch.master.admission import AttachBroker, BrokerConfig
from gpumounter_tpu_torch.master.discovery import WorkerDirectory
from gpumounter_tpu_torch.master.gateway import MasterGateway
from gpumounter_tpu_torch.master.shardring import HAConfig
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.worker.grpc_server import (WorkerClient,
                                                     load_tls_config)

logger = get_logger("master.main")


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
    # HA plane: TPU_MASTER_SHARDS / TPU_ELECTION / TPU_INTENT_STORE —
    # all default-off = single-master semantics (docs/guide/HA.md).
    ha = HAConfig.from_settings(settings)
    gateway = MasterGateway(
        kube, directory,
        worker_client_factory=lambda target: WorkerClient(target, tls=tls),
        broker=broker, ha=ha)
    server = gateway.serve(settings.master_http_port)
    logger.info("master ready on :%d (quotas=%s lease_ttl=%gs queue=%gs "
                "shards=%d election=%s store=%s replica=%s)",
                settings.master_http_port, settings.tenant_quotas or "off",
                settings.lease_ttl_s, settings.queue_timeout_s,
                ha.shards, "on" if ha.election else "off",
                "on" if ha.store else "off", ha.replica)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
