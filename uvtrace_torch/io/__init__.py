from uvtrace_torch.io.routexml import Route, LightPos, load_route_xml, save_route_xml
