"""The differentiable layer (uvtrace/diff/) in torch autograd: the G x V dose
estimator, its multi-bounce term, route optimization and the dose image."""

from uvtrace_torch.diff.estimator import (
    DiffScene,
    bounce_irradiance,
    irradiance,
    make_diff_scene,
    one_bounce_irradiance,
    route_dose,
)
from uvtrace_torch.diff.image import ImagePlan, dose_image, plan_dose_image
from uvtrace_torch.diff.optimize import RouteOptResult, optimize_route
from uvtrace_torch.diff.transfer import RouteTransfer, plan_route_transfer
