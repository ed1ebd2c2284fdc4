from uvtrace_torch.sim.params import SimParams, ViewMode
from uvtrace_torch.sim.simulator import Simulator
