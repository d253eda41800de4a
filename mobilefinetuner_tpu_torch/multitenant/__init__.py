from mobilefinetuner_tpu_torch.multitenant.engine import (EngineConfig,
                                                          MultiTenantEngine,
                                                          TenantMux)
from mobilefinetuner_tpu_torch.multitenant.jobspec import (JobSpec,
                                                           load_jobs_file,
                                                           parse_jobs)

__all__ = ["EngineConfig", "MultiTenantEngine", "TenantMux", "JobSpec",
           "load_jobs_file", "parse_jobs"]
