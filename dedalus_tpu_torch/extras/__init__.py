"""Flow tools: global reductions, flow properties and CFL control."""
