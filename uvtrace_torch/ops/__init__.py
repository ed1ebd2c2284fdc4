from uvtrace_torch.ops import rng, generate, intersect, traverse, accumulate, shade
