"""Settings, quotas, the broker and HA settings, the result enum's wire
tags and JSON logs, through both packages (the counterpart of
tests/test_config.py). The port reads the control plane's ``TPU_*``
environment names (ROADMAP Queue 3 item 27a); its resource is
``nvidia.com/gpu``."""

import importlib
import json
import logging

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def settings(pkg):
    return pkg.mod("utils.config").Settings


def test_settings_defaults(pkg, settings):
    s = settings.from_env({})
    assert s.pool_namespace == pkg.consts.DEFAULT_POOL_NAMESPACE
    assert s.cgroup_driver == "systemd"
    assert s.resource_name == pkg.resource
    assert s.allocation_timeout_s == 120.0


def test_settings_env_overrides(pkg, settings):
    consts = pkg.consts
    s = settings.from_env({consts.ENV_POOL_NAMESPACE: "my-pool",
                           consts.ENV_CGROUP_DRIVER: "cgroupfs",
                           "NODE_NAME": "node-1",
                           "TPU_ALLOCATION_TIMEOUT_S": "7.5"})
    assert (s.pool_namespace, s.cgroup_driver, s.node_name,
            s.allocation_timeout_s) == ("my-pool", "cgroupfs", "node-1", 7.5)
    with pytest.raises(ValueError):     # ref cgroup.go:78-84
        settings.from_env({consts.ENV_CGROUP_DRIVER: "bogus"})


def test_parse_tenant_quotas(pkg):
    parse = pkg.mod("utils.config").parse_tenant_quotas
    assert parse("teamA:16,teamB:8,*:4") == {"teamA": 16, "teamB": 8,
                                             "*": 4}
    assert parse("") == {} and parse(" teamA:1 , ") == {"teamA": 1}
    for bad in ("teamA", "teamA:x", ":4", "a:1,a:2", "a:-1"):
        with pytest.raises(ValueError):
            parse(bad)


def test_broker_settings_from_env(pkg, settings):
    consts = pkg.consts
    s = settings.from_env({consts.ENV_QUOTAS: "teamA:16,*:4",
                           consts.ENV_QUOTA_BURST: "1.5",
                           consts.ENV_LEASE_TTL_S: "3600",
                           consts.ENV_QUEUE_TIMEOUT_S: "30",
                           consts.ENV_QUEUE_DEPTH: "8"})
    assert (s.tenant_quotas, s.quota_burst, s.lease_ttl_s,
            s.queue_timeout_s, s.queue_depth) == (
        {"teamA": 16, "*": 4}, 1.5, 3600.0, 30.0, 8)
    s = settings.from_env({})
    assert (s.tenant_quotas, s.quota_burst, s.lease_ttl_s,
            s.queue_timeout_s) == ({}, 1.0, 0.0, 0.0)
    with pytest.raises(ValueError):
        settings.from_env({consts.ENV_QUOTA_BURST: "0.5"})


def test_broker_config_maps_settings(pkg, settings):
    consts = pkg.consts
    s = settings.from_env({consts.ENV_QUOTAS: "t:2",
                           consts.ENV_LEASE_TTL_S: "60",
                           consts.ENV_POOL_NAMESPACE: "my-pool"})
    config = pkg.mod("master.admission").BrokerConfig.from_settings(s)
    assert (config.quotas, config.lease_ttl_s, config.pool_namespace,
            config.resource_name) == ({"t": 2}, 60.0, "my-pool",
                                      pkg.resource)


def test_remove_result_wire_parity(pkg):
    """ref api.proto:32-41 skips enum tag 3."""
    assert pkg.consts.RemoveResult[pkg.fmt("{DEV}_NOT_FOUND")] == 4


def test_json_log_format(pkg, monkeypatch, capsys):
    log_mod = importlib.import_module(f"{pkg.root}.utils.log")
    monkeypatch.setenv("LOG_FORMAT", "json")
    monkeypatch.setattr(log_mod, "_configured", False)
    root = logging.getLogger("tpumounter")
    old_handlers = list(root.handlers)
    for h in old_handlers:
        root.removeHandler(h)
    try:
        log_mod.init_logger()
        log_mod.get_logger("test").info("hello %s", "world")
        obj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (obj["message"], obj["level"], obj["logger"]) == (
            "hello world", "INFO", "tpumounter.test")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in old_handlers:
            root.addHandler(h)
        monkeypatch.setattr(log_mod, "_configured", True)


def test_ha_settings_from_env(pkg, settings):
    consts = pkg.consts
    s = settings.from_env({consts.ENV_MASTER_SHARDS: "4",
                           consts.ENV_ELECTION: "1",
                           consts.ENV_ELECTION_RENEW_S: "0.5",
                           consts.ENV_ELECTION_TTL_S: "1.5",
                           consts.ENV_INTENT_STORE: "1",
                           consts.ENV_REPLICA_ID: "master-abc",
                           consts.ENV_ADVERTISE_URL: "http://10.0.0.7:8080",
                           consts.ENV_SHARD_FORWARD: "redirect"})
    assert (s.master_shards, s.election_enabled, s.intent_store_enabled,
            s.election_renew_s, s.election_ttl_s, s.replica_id,
            s.advertise_url, s.shard_forward) == (
        4, True, True, 0.5, 1.5, "master-abc", "http://10.0.0.7:8080",
        "redirect")
    s = settings.from_env({})
    assert (s.master_shards, s.election_enabled, s.intent_store_enabled,
            s.shard_forward, s.election_renew_s, s.election_ttl_s) == (
        1, False, False, "proxy", consts.DEFAULT_ELECTION_RENEW_S,
        consts.DEFAULT_ELECTION_TTL_S)
    for env in ({consts.ENV_MASTER_SHARDS: "0"},
                {consts.ENV_ELECTION_RENEW_S: "5",
                 consts.ENV_ELECTION_TTL_S: "2"},
                {consts.ENV_SHARD_FORWARD: "broadcast"}):
        with pytest.raises(ValueError):
            settings.from_env(env)


def test_ha_config_maps_settings(pkg, settings):
    consts = pkg.consts
    ha_config = pkg.mod("master.shardring").HAConfig
    ha = ha_config.from_settings(settings.from_env({
        consts.ENV_MASTER_SHARDS: "2", consts.ENV_ELECTION: "1",
        consts.ENV_INTENT_STORE: "1", consts.ENV_REPLICA_ID: "m-0",
        consts.ENV_ADVERTISE_URL: "http://m-0:8080",
        consts.ENV_POOL_NAMESPACE: "my-pool"}))
    assert (ha.shards, ha.election, ha.store, ha.replica, ha.advertise_url,
            ha.namespace, ha.enabled) == (2, True, True, "m-0",
                                          "http://m-0:8080", "my-pool", True)
    ha = ha_config.from_settings(settings.from_env({}))
    assert not ha.enabled and ha.replica


def test_settings_from_the_same_env_agree():
    """Every field read from one environment is equal in both packages,
    but the resource and the worker selector, which follow the port's
    deploy names (``app=gpu-mounter-worker``)."""
    env = {"TPU_POOL_NAMESPACE": "p", "TPU_QUOTAS": "a:2",
           "TPU_LEASE_TTL_S": "9", "TPU_MASTER_SHARDS": "3",
           "TPU_GRPC_WORKERS": "5", "NODE_NAME": "n"}
    out = {}
    for pkg in BOTH:
        s = vars(pkg.mod("utils.config").Settings.from_env(env)).copy()
        s.pop("host", None)
        assert s.pop("resource_name") == pkg.resource
        assert s.pop("worker_label_selector") == \
            f"app={pkg.dev}-mounter-worker"
        out[pkg.name] = s
    shared = set(out["jax"]) & set(out[TORCH.name])
    assert {k: out["torch"][k] for k in shared} == \
        {k: out["jax"][k] for k in shared}
