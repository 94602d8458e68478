#!/usr/bin/env bash
# Deploy helper for the PyTorch/GPU port: deploy | redeploy | uninstall the
# manifests of this directory (run from anywhere).
set -euo pipefail

cd "$(dirname "$0")/../.."

MANIFESTS=(
  deploy/gpu/namespace.yaml
  deploy/gpu/service-account.yaml
  deploy/gpu/rbac.yaml
  deploy/gpu/gpu-mounter-workers.yaml
  deploy/gpu/gpu-mounter-master.yaml
  deploy/gpu/gpu-mounter-svc.yaml
)

deploy() {
  for m in "${MANIFESTS[@]}"; do kubectl apply -f "$m"; done
}

uninstall() {
  for ((i=${#MANIFESTS[@]}-1; i>=0; i--)); do
    kubectl delete --ignore-not-found -f "${MANIFESTS[$i]}"
  done
  # namespace deletion is async; redeploy would otherwise apply into a
  # Terminating namespace and fail
  kubectl wait --for=delete namespace/gpu-pool --timeout=120s 2>/dev/null || true
}

case "${1:-}" in
  deploy)    deploy ;;
  redeploy)  uninstall; deploy ;;
  uninstall) uninstall ;;
  *) echo "usage: $0 deploy|redeploy|uninstall" >&2; exit 1 ;;
esac
