from .flow_euler import (
    FlowMatchEulerScheduler,
    dynamic_shift_mu,
    flow_sigmas_for_training,
    time_shift,
    time_shift_exp,
)
from .ddim import DDIMScheduler
from .edm_euler import EDMEulerScheduler
from .sampling import classifier_free_guidance, sample_loop
from .unipc import UniPCScheduler
