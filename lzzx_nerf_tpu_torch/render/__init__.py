from .grid_update import (make_density_grid_update, make_torso_grid_update,
                          mark_untrained_grid, update_density_grid,
                          update_torso_grid)
from .renderer import (TorsoPlan, build_torso_plan, render_rays,
                       render_rays_compact_blocks, render_rays_train_compact,
                       run_torso, run_torso_compact)
from .state import OccupancyState, RenderSettings, init_occupancy_state

__all__ = ["OccupancyState", "RenderSettings", "TorsoPlan",
           "build_torso_plan", "init_occupancy_state",
           "make_density_grid_update", "make_torso_grid_update",
           "mark_untrained_grid", "render_rays",
           "render_rays_compact_blocks", "render_rays_train_compact",
           "run_torso", "run_torso_compact", "update_density_grid",
           "update_torso_grid"]
