"""Demo: simulate a multi-target maritime scenario with AIS and track it
(counterpart of examples/demo_tracking.py).

    python -m pymht_tpu_torch.examples.demo_tracking [--targets 6]
        [--scans 20] [--out DIR] [--no-plot] [--device cpu]

Steps ``utils/scenes.demo_scene`` (T=32, L=32, M=64, A=8, W=7; six
targets with transponders in a 1 km radar, 21 scans) through
``Tracker(method='ipm', use_ais=True)`` and writes ``demo_run.xml`` (the
reference-compatible result export, ``utils/xml_io``) and, unless given
``--no-plot``, ``demo_scene.png`` (truth, measurements, smoothed tracks,
gates; ``utils/plotting``) into ``--out``.  Plotting needs matplotlib:
without it the demo raises rather than skip the figure.
"""
from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

from ..core.tracker import Tracker
from ..utils import plotting, scenes, xml_io


def plot_scene(path, tracker, scans, sim_list):
    """The figure of the run, written to ``path``."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("demo_tracking: plotting needs matplotlib, which "
                           "is not installed; pass --no-plot to run without "
                           "the figure") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(9, 9))
    plotting.plot_ground_truth(ax, sim_list)
    plotting.plot_measurements(ax, scans, alpha=0.3)
    plotting.plot_tracks(ax, tracker, smooth=True)
    plotting.plot_validation_regions(ax, tracker)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--targets", type=int, default=6)
    ap.add_argument("--scans", type=int, default=20)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--clutter", type=float, default=2e-6)
    ap.add_argument("--out", default=".")
    ap.add_argument("--no-plot", action="store_true",
                    help="write the XML only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    shapes, params, scans, ais_groups, sim_list = scenes.demo_scene(
        args.targets, args.scans, args.seed, args.clutter)
    tracker = Tracker(shapes, params, method="ipm", use_ais=True,
                      device=args.device)
    for s, msgs in zip(scans, ais_groups):
        tracker.add_measurement_list(s.time, s.measurements, msgs)

    ids, _ = tracker.get_track_states()
    print(f"{len(ids)} active tracks after {len(scans)} scans")
    tracker.print_time_log()

    if not args.no_plot:
        scene_png = os.path.join(args.out, "demo_scene.png")
        plot_scene(scene_png, tracker, scans, sim_list)
        print("wrote", scene_png)

    scenario = ET.Element(xml_io.SCENARIO)
    xml_io.store_ground_truth(scenario, sim_list, (0., 0.),
                              params.radar_range, params.radar_period,
                              sim_list[0][0].time)
    xml_io.store_tracker_settings(scenario, shapes, params, seed=args.seed)
    xml_io.store_run(scenario, tracker, smooth=True, i=0)
    run_xml = os.path.join(args.out, "demo_run.xml")
    xml_io.write_element_to_file(run_xml, scenario)
    print("wrote", run_xml)


if __name__ == "__main__":
    main()
