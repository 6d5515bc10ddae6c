"""Campaign gateway: a persistent multi-tenant design service.

One resident executor/allocator/payload multiplexes many tenants'
campaigns as protocol bindings on a shared coordinator — cross-campaign
coalescing fuses co-tenant same-bucket batches, per-tenant quotas bound
each tenant's device footprint, and a stdlib HTTP front-end exposes the
whole thing as a JSON API. See ``service`` for the control plane,
``quotas`` for the resource model, ``server`` for the wire surface.

A port of the JAX package's ``repro.gateway``.
"""

from repro_torch.gateway.quotas import (TENANT_BAND_STRIDE, QuotaManager,
                                  TenantQuota, tenant_band)
from repro_torch.gateway.server import make_server, serve_forever
from repro_torch.gateway.service import (CampaignState, GatewayError,
                                   GatewayService)

__all__ = [
    "TENANT_BAND_STRIDE", "QuotaManager", "TenantQuota", "tenant_band",
    "make_server", "serve_forever", "CampaignState", "GatewayError",
    "GatewayService",
]
