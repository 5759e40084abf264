"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (every failed check raises, so the exit
code is non-zero and no result line is printed):

1. device    — needs ``torch.cuda.is_available()``; prints the card's
               name and power limit (nvidia-smi).
2. build     — builds the seven CUDA sources from ``csrc/``
               (fused_update, table_lookup, rowwise_lookup, latch_scan,
               bars_raster, smooth_scan, graph_while), the nvcc runs
               side by side.
3. kernel    — each kernel vs its plain torch version on the card.
               fused_update at every n in {256, ..., 65536} (clusters of
               1 to 16 CTAs), B in {1, 2, 128}, F in {1, 6, 16}, and F 24
               at n 16384 (the streamed route, which n 32768 and 65536
               take from F 4): 8 updates of fresh audio with staggered per-row
               slots; gravity, average and the written history slot
               within 2e-5, the other history slots bit-identical. Its
               split route (``SPLIT_CASES``: n 131072 and 262144 at B 2
               and 128, n 524288, 2^21 and 2^22 at B 2, 2^24 at B 1,
               F 6, and n 131072 B 2 at F 1, 16 and 32: every class of
               split plan; column FFTs, then the k-point stage and the
               epilogue): 4 updates each, one split launch an update,
               within 2e-5 or, where larger, the plain version's own
               distance from a float64 model.
               table_lookup BIT-IDENTICAL (torch.equal) on: radial's
               162-entry table at its 1920x1080 id plane, an 8192-entry
               table at circle's three 1920x1080 site planes, a
               32768-entry table (the dynamic shared memory path), a
               131072-entry table (read from the L2: circle's at
               bufsize 65536), a random 2M-point plane, a 97-point plane
               and a (3, T) table; an out-of-range static plane must
               raise.
               latch_scan BIT-IDENTICAL, one launch a call, at (1081,
               1920), (601, 800), (97, 131), (1, 7), (7, 1), (4097, 96)
               and a 1080p plane with keys worse than the sentinel, C in
               {0, 4}, both directions; rowwise_lookup BIT-IDENTICAL,
               one launch a call on the route ``rowwise_plan`` gives,
               C in {1, 4}, on every ``ROWWISE_CASES`` entry: uniform,
               constant, monotone and random index planes on the ``.T``
               views of 1080p (H, W) planes the interpreter passes,
               contiguous operands, views off a 16-byte boundary,
               broadcast (stride 0) tables, 97x131, T 1 and tables too
               tall for shared memory (the direct route); each
               (C, route) pair must be seen. bars_raster BIT-IDENTICAL
               at S = 64 streams 800x600 and 1920x1080 and at S = 1
               through a MIRROR_YX view (rows 1920, columns 1080, read
               transposed), both outline branches, per-stream and shared
               colour tables. smooth_scan at sz 4096 and 65536 (the
               tables in device memory), ratio 4 and 1, distance 0.01
               and 0.5, on rows with about 20% exact zeros and an empty
               first window, each on its fast walk and again with every
               row on its exact walk from bin 1, then at sz 4096 on
               ``SMOOTH_BRANCHES`` rows (an exact cancellation, +inf,
               -inf, a NaN, a silent row, distance 0): one launch a
               call, the zero positions (NaN -> 0 and the input's zeros)
               identical, the values within 1e-5 of the plain version,
               and the rows each walk finished as the case requires.
               The while node's setter (graph_while) equal to its plain
               version (``condition_plain``) on 1080p, 800x600, 97x131
               and 1x7 planes with no pixel active, the first, the last
               and many, the fuel below and at the cap; then a loop and
               a loop nested in it captured once (a conditional while
               node, the inner one in its body) and replayed at trip
               counts a device tensor sets (9, 30, 0 and the fuel cap
               100), under ``sync_errors``, equal to the host-driven
               loop; the setter's time on 1920x1080 planes by CUDA
               events and by torch.profiler inside replays of a
               captured 30-trip loop.
4. main path — ``Engine`` with the synth backend and a null sink, the
               kernel counts set to 0 just before each run and read
               just after: bars (the shipped rc.glsl) at 800x600 and
               1920x1080, radial and circle at 800x600 and 1920x1080
               (bufsize 4096), wave and graph at 800x600, and five user
               GLSL shader modules written into a temporary config dir
               (``SHADER_MODULES``: docs/examples/rings, a first-hit
               anti-alias walk, a fetch at run-time rows, a `window,
               smooth` uniform, one smooth_scan a frame, and a loop
               whose trip count the audio sets, a while node) at
               800x600 and 1920x1080, each through its compiled step. The CPU path (``CPU_PATH_RUNS``: bars with
               ``setaccelfft false``, ``setinterpolate`` on and off)
               through ``Engine``: the chain route, no fused_update
               launch; its cuda frame after 24 frames (audio every
               other frame, interp_mod 0.5 between) against the cpu
               frame under the golden rule. fused_update launches must equal the
               audio updates of fft modules; table_lookup launches and
               rowwise_lookup and latch_scan launches by channel count
               C the frames times each module's launches a frame
               (``LAUNCHES``; bars launches the raster once a frame;
               the audio loop's fetch and setter launches, which its
               data sets, ``DATA_LAUNCHES``, must be nonzero).
               ``FleetEngine`` with 64 bars streams (the shipped rc.glsl,
               bufsize 4096, per-stream synth tones and ``fg`` colours) at
               800x600 and 1920x1080: one fused_update launch a frame over
               B = 128 rows and one bars_raster launch a frame; a mixed
               fleet (bars, radial, wave; S = 6) adds one table_lookup a
               frame for its radial group; 64 circle streams at 800x600
               and 1920x1080 one table_lookup a frame for every stream;
               an S 64 fleet of the six native modules and rings, with
               fg/bg rows, one lookup a frame each for its radial and
               circle groups and one a rings stream. An S = 4 fleet's
               cuda frames must meet its cpu frames under the golden
               rule; the circle fleets and the all-module fleet, on
               fixed tones with fg/bg rows, streams 0, 31, 63 and each
               module's first must meet one-stream cpu renders
               (``_fleet_parity``). ``log_mel`` of 30 s of 16 kHz audio
               (3001 frames) on cuda within 2e-5 of the peak of the cpu
               features. Every
               row-wise launch of the main path must take the staged
               route. ``Renderer`` at ``BUFSIZE_REQUESTS``: bars and
               circle (a 65536-entry table, read from the L2) at
               setbufsize 32768 on the fused kernel (one launch an
               update), and bars at setbufsize 4096 with setbufscale 32
               (scaled 128, below the kernel's sizes) on the plain
               chain, no fused launch, and bars at setbufsize 131072
               with the smooth pass off (a user smooth_parameters.glsl)
               on the split route, one split launch an update; each
               cuda frame meets the cpu frame under the golden rule.
               One ``AudioPipeline`` update at bufsize 2^25 (above the
               split plans) on the chain route, no fused or split
               launch, its textures within 5e-5 of the cpu update's.
               The smoothy runs print the rows each smooth_scan walk
               finished.
               Sharded fleets (``phase_sharded``, ``SHARDED_FLEETS``: 64
               bars streams, a mixed bars/radial/wave fleet of 24 and
               an S 8 fleet of every native module and rings) through
               ``FleetEngine(mesh=...)`` over ``shard_meshes``:
               ``[cuda:0]``, ``[cuda:0, cuda:0]`` on the streams axis,
               ``[cuda:0] x 2`` on rows 2 (each device a band of
               rows), ``[cuda:0] x 4`` as 2 streams x 2 rows and, with
               more than one card, every card on streams and on rows
               2: 4 frames of fixed snapshots byte-equal to the
               unsharded fleet's, launches the sum over the devices of
               what the unsharded fleet launches for each device's
               block of streams (the device count times its, where
               every block holds every module), each row group's state
               replicas torch.equal, rings' whole-frame band renders
               counted; the bars raster and the table lookup against
               their plain versions at the band shapes
               (``_band_kernels``); then on every card the kernels
               whose shared-memory opt-in is per device against their
               plain versions.
               ``Engine.run_tests()`` (test_rc.glsl) must pass on cuda.
               Every module's frame after 24 updates of fixed stereo
               tones renders on cuda and cpu at 800x600 and must meet
               the golden rule (under 0.2% of pixels more than 2 LSB
               apart), and the built-in ones at tests/golden/frames.npz's
               size against the archive.
               The host runtime (``phase_host``): one stream of device
               frames through the Engine's own fetch path
               (``FrameFetch``) at 1920x1080, bars and circle, at
               inflight 0, 1 and 2, with a y4m sink (the yuv420 wire,
               packed on the device) and a null sink (rgba8): every
               buffer handed to the sink pinned and byte-equal to a
               synchronous ``.cpu()`` of its device frame, with fresh
               device allocations written between steps; YUV planes
               within 1 LSB of ``yuv420_pack_host`` of the RGBA frame;
               ``FleetEngine.fetch`` of 8 streams at 1920x1080 pinned
               and byte-equal to ``.cpu()``. ``--pipe`` values (``fg = #00ff00`` on the pipe stream)
               through Engine for bars, graph and a shader module with
               an ``@fg`` knob, and the ``--stdin`` bind (a bare
               ``#00ff00`` into ``STDIN``) for a shader module with an
               ``@STDIN`` knob, cuda frames against cpu frames under the
               golden rule (fixed tones as audio); a ``setbgimg``
               wallpaper under ``setopacity "xroot"``, cuda against cpu,
               and a wallpaper swapped mid-run reaching the composite;
               ``api.entry(["--device", "cuda", ...])`` with ``wait``,
               ``tex``, ``sizereq`` and ``terminate``; an Engine on the
               ``fifo`` backend fed through an ``os.mkfifo``, and one on
               the ``pulseaudio`` backend's pa_simple path over a
               stand-in libpulse.
               The port's own entry points (``phase_entry_points``), the
               counts set to 0 just before and read just after:
               ``entry()``'s bars 512x256 step on cuda against the same
               fn on cpu under the golden rule; ``dryrun_multichip(4)``
               on ``cuda:0`` four times (tiny parity, 1080p bands on
               their devices, the scaling table, the hosts mesh, the
               FleetEngine on the mesh: five OK lines); every section
               of ``glava_tpu_torch.bench`` once at its real shapes with
               short counts (the interpreted section ``null`` without
               the reference's shaders, then run on rings at 1080p),
               every key of the line there and every number finite and
               positive; the fused update, the table lookup and the
               bars raster each launched.
               The compiled steps (``phase_compiled``; the Engine, the
               fleet, ``render_wav``, ``entry()`` and the bench above
               already run them): every native module at 800x600 and
               circle at 1920x1080, rgba8 and yuv420, ``jit_step``; bars
               at bufsize 131072 (the split route, its programmatic
               dependent launch captured), ``jit_update`` at 131072 and
               at 2^25 (the chain route), and bars on the CPU path; the
               S 64 bars and circle fleets and a mixed S 24 fleet, a
               pipe write every frame (one capture, the values static
               inputs); the bars fleet sharded over ``[cuda:0,
               cuda:0]`` on streams and on rows 2; ``render_wav`` and
               ``entry()``; every GLSL shader module at 800x600 and
               rings and colfetch at 1920x1080 (a pipe write every
               frame on every single-stream case): 24 replays of each
               byte-equal to the eager step on the same inputs, each
               replay under ``torch.cuda.set_sync_debug_mode("error")``,
               the captures where the case puts them (each branch's
               first call), the replays' launch counts the frames times
               ``LAUNCHES`` (the fused update once an update), and a
               profile of a few replays showing those kernels (the
               table lookup, the row-wise lookup, the latch scan, the
               smooth scan and the while setter inside the graphs);
               then the user Python module vu_meter (one stream, a
               fleet of 8, a mixed bars/vu_meter fleet of 8 and the
               fleet sharded over ``[cuda:0] x 2`` on rows 2) the same
               way, one capture a branch (a device block), and a user
               module that reads a tensor on the host and one that
               synchronises the card inside its capture, each refused
               by name (``compiled.Uncapturable``), no stream left
               capturing, and bars' compiled step after each.
5. times     — device times of each kernel and its plain version at
               the main path's shapes, and of one PyTorch call computing
               the same function where there is one: fused_update
               (``FUSED_TIMED``: n 4096 to 262144 at B 2 and 128, n
               524288 at B 2; the split route above 65536, with each of
               its two kernels' profiler time; bound the
               larger of bytes and float64 FFT operations), latch_scan and
               torch.cummax at (1081, 1920) (the latch also at (601,
               800)), bars_raster (S = 64 at 800x600 and 1920x1080) and
               rowwise_lookup and C x torch.gather (1080p .T views, C in
               {1, 4}, each index pattern, and C = 4 on the colfetch
               1080p frame's own inputs, captured as the interpreter
               hands them over) from CUDA events around
               back-to-back launches on fresh inputs held behind a spin
               kernel (``event_ms``), fused_update and latch_scan also
               from torch.profiler on one warm input set, the others
               from torch.profiler; fused_update also at n 32768 and
               65536; smooth_scan (events) at the checked shapes and
               its plain version at the main path's (1 row, sz 4096);
               the CPU-path bars frame at both sizes; log_mel frames/s;
               CUDA-event frame times of
               bars, radial and circle and of the shader modules at
               800x600 and 1920x1080 (each frame brought to the host
               through ``FrameFetch``, pinned); fleet frame times at S in {1, 8,
               64} at both sizes and the 64-stream circle fleet, split
               into the device step and the frame copy, with the device
               busy share; a profiler
               breakdown of bars at 800x600, circle at 1920x1080, the
               anti-alias walk module at 1920x1080 and the 64-stream
               fleet at 800x600 (the fleet's frame copy through
               ``FleetEngine.fetch``, pinned). The host runtime
               (``host_times``): device-to-host copy rates, pageable
               ``.cpu()`` against pinned, for a 1920x1080 RGBA8 frame,
               its YUV420 packing and the S 64 1920x1080 fleet frame
               (CUDA events); Engine fps at 1920x1080, bars and circle,
               inflight 0, 1, 2, rgba8 and yuv420 wires, five alternating
               rounds; ``FleetEngine.run`` of 64 bars streams at 800x600
               on the native seqlock ring and on the Python ring,
               alternating (host clock); the S 64 bars fleet frame
               unsharded and on every ``shard_meshes`` mesh, and the
               S 64 circle fleet at 1920x1080 unsharded, on
               ``[cuda:0] x 2`` rows 2 and, where there are several
               cards, on every card on streams and on rows 2 (else
               printed as not measured), host clock, split into the
               step and the pinned copy, with the copy's rate, each by
               the compiled step and by the eager step in its place.
               Eager against captured (``_compiled_times``): each native
               module's frame at 800x600 and circle's at 1920x1080, bars
               with a pipe write every frame, each shader module's at
               800x600 and rings' and colfetch's at 1920x1080, the user
               module vu_meter's at 800x600 (host
               clock and device time under the profiler, busy share,
               each kernel's device time, CUDA events), the split
               route's update in and out of a graph (each kernel's
               profiler time, events, host time), and the S 64 bars and
               circle fleets at both sizes. The while setter's time on
               a 1080p plane against its plain version and its bound.

The second-to-last line is the kernels JSON, the last the device JSON.

    python3 chip_smoke.py --sharded [PARENT]

runs only the build, the sharded fleets, the per-card kernels,
``dryrun_multichip(4)`` over the first four cards (repeated where fewer)
and the sharded fleets' times (bars S 64, circle S 64 at 1920x1080; on a
machine of several cards, what it adds);
with PARENT (another tree unpacked there) first that tree's per-device
kernels on every card, in a process of its own package. It also reads
the weak-scaling table of ``dryrun_multichip`` by the eager update
beside the compiled one (``_eager_scaling_table``).

    python3 chip_smoke.py --compiled [PARENT]

runs only the build, the while node's checks, ``phase_compiled`` and
the eager-against-captured times; with PARENT (another tree, for example the parent commit, whose
bench runs every step eagerly) the ``glava_tpu_torch.bench`` line and
``bench.windows_spread()`` of PARENT and of this tree, each in a
process of its own tree (parent, this, this, parent).

    python3 chip_smoke.py --fused-ab DIR [DIR ...]

times the fused update of other trees beside this checkout's instead
(``fused_ab``), on the one-cluster route and the split route: each DIR
holds a tree's ``ops/fused.py`` and ``csrc/fused_update.cu``.

    python3 chip_smoke.py --smooth-ab DIR [DIR ...]

times the smooth transform of other trees beside this checkout's
(``smooth_ab``): each DIR holds a tree's ``ops/smooth.py`` and
``csrc/smooth_scan.cu``.

    python3 chip_smoke.py --while-ab DIR [DIR ...]

times the while node's setter of other trees beside this checkout's
(``while_ab``): each DIR holds a tree's ``ops/graph_while.py`` and
``csrc/graph_while.cu``.

    python3 chip_smoke.py --ab PARENT

times another tree unpacked at PARENT (for example the parent commit,
``git archive``) beside this checkout, in alternating processes, each
running its own tree's package and kernels (``frames_ab``): the
row-wise lookup at C = 4 on the colfetch 1080p frame's own inputs and
on a random plane, the colfetch 1080p, bars and fleet frames (S 1 and
64 at 800x600, S 64 at 1920x1080, each tree's own frame copy), the S 64
circle fleet frames at both sizes (no pipe values: a tree before the
circle's stream axis refuses them) and the circle 1920x1080 Engine
frame.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from glava_tpu_torch.utils.timing import (
    bound_ms, cuda_ms, device_ms, event_ms, fused_bound, host_ms, kernel_ms,
    synchronize, update_bytes,
)

TOL = 2e-5           # spectra (the JAX suite's fused-vs-unfused tolerance)
ROOT = Path(__file__).resolve().parent
KERNELS = ("fused_update", "table_lookup", "rowwise_lookup", "latch_scan",
           "bars_raster", "smooth_scan", "graph_while")
# what the main path launches, a kernel for each C it takes: the kernels
# JSON has one entry each; "rowwise_lookup C=1" (checked, timed) must
# stay off the path
PATH = ("fused_update", "fused_update split", "table_lookup",
        "rowwise_lookup C=4", "latch_scan C=0", "latch_scan C=4",
        "bars_raster", "smooth_scan", "graph_while")
COUNTED = PATH + ("rowwise_lookup C=1",)
MODULES = ("bars", "radial", "circle", "wave", "graph", "test")

# -- user GLSL shader modules (<user_dir>/<name>/{1,2}.frag) -------------

BASE_FRAG = """
/* A spectrum bar pass (the interpreter tests' first pass): smoothed
 * audio per column, a shaded bar below it, transparent above. */
in vec4 gl_FragCoord;
#request uniform "screen" screen
uniform ivec2 screen;
#request uniform "audio_sz" audio_sz
uniform int audio_sz;
#request uniform "audio_l" audio_l
#request transform audio_l "window"
#request transform audio_l "fft"
#request transform audio_l "gravity"
#request transform audio_l "avg"
uniform sampler1D audio_l;
out vec4 fragment;

void main() {
    float pos = gl_FragCoord.x / screen.x;
    float v = smooth_audio(audio_l, audio_sz, pos) * 250;
    if (gl_FragCoord.y < v) {
        float t = clamp(gl_FragCoord.y / v, 0.0, 1.0);
        fragment = vec4(vec3(0.13, 0.67, 0.4) * (1.0 - 0.5 * t), 1.0);
        return;
    }
    fragment = vec4(0, 0, 0, 0);
}
"""

AA_WALK_FRAG = """
/* Anti-alias pass in the manner of graph/3.frag: walk each column from
 * the pixel to the edge of the drawn area (first-hit walks: the key
 * scan), then blend towards the texel at the edge (fetches at the walk
 * results: the latch scan). */
in vec4 gl_FragCoord;
#request uniform "screen" screen
uniform ivec2 screen;
#request uniform "prev" tex
uniform sampler2D tex;
out vec4 fragment;

float get_col_height_up(float x, float oy) {
    float y = oy;
    while (y < screen.y) {
        vec4 f = texelFetch(tex, ivec2(x, y), 0);
        if (f.a <= 0) {
            y -= 1;
            break;
        }
        y += 1;
    }
    return y;
}

float get_col_height_down(float x, float oy) {
    float y = oy;
    while (y >= 0) {
        vec4 f = texelFetch(tex, ivec2(x, y), 0);
        if (f.a > 0) {
            break;
        }
        y -= 1;
    }
    return y;
}

void main() {
    fragment = texelFetch(tex, ivec2(gl_FragCoord.x, gl_FragCoord.y), 0);
    float a0 = get_col_height_up(gl_FragCoord.x - 1, gl_FragCoord.y);
    float a1 = get_col_height_up(gl_FragCoord.x + 1, gl_FragCoord.y);
    float b = get_col_height_down(gl_FragCoord.x, gl_FragCoord.y);
    vec4 edge = texelFetch(tex, ivec2(gl_FragCoord.x - 1, a0), 0);
    vec4 below = texelFetch(tex, ivec2(gl_FragCoord.x, b), 0);
    if (fragment.a <= 0) {
        float d = min(abs(gl_FragCoord.y - a0), abs(gl_FragCoord.y - a1));
        float k = clamp(1.0 - d / 4.0, 0.0, 1.0) * 0.5;
        fragment = mix(fragment, edge, k);
    } else {
        float t = clamp((gl_FragCoord.y - b) / 64.0, 0.0, 1.0);
        fragment = mix(below, fragment, 0.5 + 0.5 * t);
    }
}
"""

COL_FETCH_FRAG = """
/* Fetches of the previous pass at rows known only at run time: at an
 * audio-driven row and at a walk result in another column than the
 * walk's (the row-wise lookup, four channels in one launch, each). */
in vec4 gl_FragCoord;
#request uniform "screen" screen
uniform ivec2 screen;
#request uniform "audio_l" audio_l
#request transform audio_l "window"
#request transform audio_l "fft"
#request transform audio_l "gravity"
#request transform audio_l "avg"
uniform sampler1D audio_l;
#request uniform "prev" tex
uniform sampler2D tex;
out vec4 fragment;

float top(float x) {
    float y = gl_FragCoord.y;
    while (y < screen.y) {
        vec4 f = texelFetch(tex, ivec2(x, y), 0);
        if (f.a <= 0) {
            break;
        }
        y += 1;
    }
    return y;
}

void main() {
    float h2 = top(gl_FragCoord.x);
    vec4 c = texelFetch(tex, ivec2(gl_FragCoord.x + 1, h2), 0);
    float v = texture(audio_l, gl_FragCoord.x / screen.x).r;
    vec4 d = texelFetch(tex, ivec2(gl_FragCoord.x, v * screen.y * 4.0), 0);
    vec4 here = texelFetch(tex, ivec2(gl_FragCoord.x, gl_FragCoord.y), 0);
    fragment = max(here, vec4(c.rgb * 0.5, c.a * 0.5))
               + vec4(0, 0, d.g * 0.25, d.a * 0.25);
}
"""

SMOOTH_FRAG = """
/* A stateless audio uniform through the `smooth` transform: the feed
 * audio, log-scale averaged bin by bin, drawn as a column height. */
in vec4 gl_FragCoord;
#request uniform "screen" screen
uniform ivec2 screen;
#request uniform "audio_l" audio_l
#request transform audio_l "window"
#request transform audio_l "smooth"
uniform sampler1D audio_l;
out vec4 fragment;

void main() {
    float v = texture(audio_l, gl_FragCoord.x / screen.x).r * screen.y;
    if (gl_FragCoord.y < v) {
        fragment = vec4(0.2, 0.6, 0.9, 1.0);
        return;
    }
    fragment = vec4(0, 0, 0, 0);
}
"""

AUDIO_LOOP_FRAG = """
/* A loop whose trip count the audio sets: each column climbs while the
 * spectrum, read again one bin further at each step, stays above the
 * step's level. The condition reads a texture, so the loop is the
 * general masked loop (a while node in a captured step), its trip
 * count changing from frame to frame; the colour takes the pipe's
 * `fg` where it is bound. */
in vec4 gl_FragCoord;
#request uniform "screen" screen
uniform ivec2 screen;
#request uniform "time" time
uniform float time;
#request uniform "audio_l" audio_l
#request transform audio_l "window"
#request transform audio_l "fft"
#request transform audio_l "gravity"
#request transform audio_l "avg"
uniform sampler1D audio_l;
out vec4 fragment;

#define LEVEL_COLOR @fg:vec4(0.2, 0.6, 1.0, 1.0)

void main() {
    float x = gl_FragCoord.x / screen.x;
    float level = 0.0;
    float n = 0.0;
    while (n < 48.0 && texture(audio_l, x + n / 512.0).r * 40.0 > n) {
        level += 1.0 / 48.0;
        n += 1.0;
    }
    float t = 0.75 + 0.25 * sin(time * 2.0 + x * 6.0);
    if (gl_FragCoord.y / screen.y < level) {
        fragment = LEVEL_COLOR * vec4(t, t, t, 1.0);
    } else {
        fragment = vec4(0, 0, 0, 0);
    }
}
"""

# a loop each pixel runs min(x, 6) times (gl_FragCoord.x from 0.5): at a
# fuel cap of FUEL_CAP every pixel right of x = FUEL_CAP is truncated
FUEL_FRAG = """
in vec4 gl_FragCoord;
out vec4 fragment;
void main() {
    float acc = 0.0;
    float i = 0.0;
    while (i < gl_FragCoord.x) {
        acc += 2.0;
        i += 1.0;
        if (acc > 10.0) break;
    }
    fragment = vec4(acc / 16.0, 0, 0, 1);
}
"""
FUEL_CAP = 4

RINGS = ROOT / "docs" / "examples" / "rings"
SHADER_MODULES = {
    "rings": lambda: tuple((RINGS / f"{i}.frag").read_text() for i in (1, 2)),
    "aawalk": lambda: (BASE_FRAG, AA_WALK_FRAG),
    "colfetch": lambda: (BASE_FRAG, COL_FETCH_FRAG),
    "smoothy": lambda: (SMOOTH_FRAG,),
    "audioloop": lambda: (AUDIO_LOOP_FRAG,),
}

# kernel launches a frame (fused_update: one an audio update instead).
# rings: one smooth_audio table fetch (its polar index plane). aawalk:
# the bar pass's smooth_audio fetch; three first-hit walks whose two
# signatures make two key scans (C = 0), the x+1 up-walk sharing the
# x-1 scan; two fetches at walk results in the walks' own columns, two
# latch scans (C = 4). colfetch: two table fetches (smooth_audio and
# texture); one walk, one key scan; the fetch at the walk result in
# the next column and the fetch at the audio-driven row, one row-wise
# lookup with C = 4 each. smoothy: the smooth transform of its stateless
# uniform (every frame: it reads the feed) and one texture fetch.
LAUNCHES = {
    "bars": {"bars_raster": 1}, "wave": {}, "graph": {}, "test": {},
    "radial": {"table_lookup": 1}, "circle": {"table_lookup": 1},
    "rings": {"table_lookup": 1},
    "aawalk": {"table_lookup": 1, "latch_scan C=0": 2, "latch_scan C=4": 2},
    "colfetch": {"table_lookup": 2, "rowwise_lookup C=4": 2,
                 "latch_scan C=0": 1},
    "smoothy": {"table_lookup": 1, "smooth_scan": 1},
    "audioloop": {},
    # user Python modules: their passes are torch operations only
    "vu_meter": {}, "timed": {}, "timedb": {},
}
# kernels whose launches a frame the data sets: audioloop's texture
# fetch runs once before its loop and once an iteration, its while
# setter once before the node and once an iteration (checked nonzero)
DATA_LAUNCHES = {"audioloop": ("table_lookup", "graph_while")}


# the modules with no fft uniform: wave reads the feed, smoothy's one
# uniform is stateless (`window, smooth`); no fused launch on their path
NO_FFT = ("wave", "smoothy")


def write_shader_modules(root: Path) -> Path:
    """Write every ``SHADER_MODULES`` entry as ``root/<name>/<k>.frag``
    (a config dir for ``loader.load(user_dir=root)``); returns root."""
    for name, frags in SHADER_MODULES.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for i, src in enumerate(frags(), start=1):
            (d / f"{i}.frag").write_text(src)
    return root


def golden_rule(got: np.ndarray, want: np.ndarray) -> float:
    """Share of pixels more than 2 LSB apart; must stay under 0.002."""
    if got.shape != want.shape:
        raise AssertionError(f"frame shapes differ: {got.shape} vs {want.shape}")
    return float((np.abs(got.astype(np.int16) - want.astype(np.int16)) > 2).mean())


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"[1 device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return card


def phase_build():
    from glava_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.load_all()
    total = time.perf_counter() - t0
    if tuple(built) != KERNELS:
        raise AssertionError(f"built {tuple(built)}, expected {KERNELS}")
    for name, b in built.items():
        ptxas = " | ".join(ln.strip() for ln in b.log.splitlines()
                           if "registers" in ln or "smem" in ln)
        print(f"[2 build] {name}: nvcc {b.seconds:.2f} s, {b.path.name}; "
              f"{ptxas or 'no ptxas log'}")
    print(f"[2 build] {len(built)} kernels built and loaded in {total:.2f} s")


def _plain_to_model(pcm, grav, hist, slot, scale, cutoff, g, window, w_age,
                    pg, pavg) -> float:
    """How far the plain version's gravity and average lie from a float64
    numpy model of the update on its first two rows: where that exceeds
    TOL, the plain float32 chain itself drifts further than the
    tolerance."""
    n = pcm.shape[1]
    m = n // 2
    F = hist.shape[1]
    h = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    worst = 0.0
    for r in range(min(2, pcm.shape[0])):
        x = h(pcm[r]) * h(window)
        spec = np.fft.fft(x[0::2] + 1j * x[1::2])
        inter = np.stack([spec.real, spec.imag], axis=-1).reshape(n)
        boost = np.maximum(np.arange(n) / n * h(scale[r]) + 1.0 - h(cutoff[r]),
                           1.0)
        spec = np.clip(np.log(np.abs(inter) + 1.0) / 3.0 * boost, 0.0, 1.0)
        spec = spec.reshape(m, 2).T
        gv = np.clip(np.maximum(h(grav[r]), spec) - h(g[r]), 0.0, 1.0)
        sl = int(slot[r]) % F
        hr = h(hist[r])
        hr[sl] = gv
        w = h(w_age)[(sl - np.arange(F)) % F]
        avg = np.clip(np.einsum("f,fcm->cm", w, hr), 0.0, 1.0)
        worst = max(worst, float(np.abs(h(pg[r]) - gv).max()),
                    float(np.abs(h(pavg[r]) - avg).max()))
    return worst


def _tolerance(args, pg, pavg) -> float:
    """The fused update's tolerance on inputs ``args`` (as
    ``fused_update`` takes them) whose plain gravity and average are
    ``pg``, ``pavg``: TOL, or on the split route the plain version's own
    distance from a float64 model where that is larger."""
    from glava_tpu_torch.ops import fused

    if not fused.fft_plan(args[0].shape[1]).split:
        return TOL
    return max(TOL, _plain_to_model(*args, pg, pavg))


def _case(n: int, B: int, F: int, rng, updates: int = 8) -> float:
    """``updates`` updates of fresh audio through the kernel and its
    plain version, staggered per-row slots; gravity, average and the
    written history slot within TOL (or, on the split route, within the
    plain version's own distance from a float64 model where that is
    larger), the other slots bit-identical. Returns the worst error."""
    from glava_tpu_torch.ops import fused, windows

    dev = torch.device("cuda")
    m = n // 2
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    window = t(windows.pcm_window(n))
    w_age = t(fused.age_weights(windows.avg_weights(F, True, True)))
    grav = t(rng.uniform(0, 1, (B, 2, m)))
    hist = t(rng.uniform(0, 1, (B, F, 2, m)))
    count = np.arange(B) % F                  # staggered per-row slots
    worst = 0.0
    for _ in range(updates):
        pcm = t(rng.standard_normal((B, n)) * 0.3)
        scale = t(rng.uniform(5.0, 20.0, B))
        cutoff = t(rng.uniform(0.0, 0.5, B))
        g = t(rng.uniform(0.01, 0.1, B))
        slot = t(count, torch.int32)
        pg, ph, pavg = fused.fused_update_plain(
            pcm, grav, hist, slot, scale, cutoff, g, window, w_age)
        kg, kh, kavg = fused.fused_update(
            pcm, grav.clone(), hist.clone(), slot, scale, cutoff, g,
            window, w_age)
        torch.cuda.synchronize()
        written = torch.zeros((B, F), dtype=torch.bool, device=dev)
        written[torch.arange(B, device=dev), slot.long()] = True
        errs = {
            "grav": (kg - pg).abs().max().item(),
            "avg": (kavg - pavg).abs().max().item(),
            "slot": (kh[written] - ph[written]).abs().max().item(),
        }
        if not torch.equal(kh[~written], hist[~written]):
            raise AssertionError(f"n={n} B={B}: unwritten history slots changed")
        tol = _tolerance((pcm, grav, hist, slot, scale, cutoff, g, window,
                          w_age), pg, pavg)
        if not all(np.isfinite(v) and v <= tol for v in errs.values()):
            raise AssertionError(f"n={n} B={B}: kernel vs plain {errs} > {tol}")
        worst = max(worst, *errs.values())
        grav, hist = kg, kh
        count = (count + 1) % F
    torch.cuda.synchronize()
    return worst


# (n, B, F) of the fused update's checks: every one-cluster bufsize
# at one stream, one stereo stream and 64; a ring of 1, 6 (the shipped
# avg frames) and 16 slots; and at n 16384 a ring of 24 slots, more than
# shared memory holds, which takes the streamed route (as n 32768 and
# 65536 do from 4 slots; 65536 runs on clusters of 16 CTAs)
FUSED_CASES = tuple((256 << i, B, F) for i in range(9) for B in (1, 2, 128)
                    for F in (1, 6, 16)) + ((16384, 2, 24), (16384, 128, 24))


# (n, B, F) of the split route's checks (n above 65536: column FFTs, then
# the k-point stage and the epilogue, two launches through device memory):
# one case of each class of split plan (fused.FFTPlan.split_points,
# split_copy and split_slots): k 32-128, 1024-point stage CTAs, history
# by tensor copy, one box a slot; k 512, 2048 points, two boxes a slot;
# k 1024, 4096 points, runs of 4 floats, the ring streamed through 2
# slots; k 4096, runs of 1 float by cp.async, the k-point twiddles read
# from device memory; and at k 32 rings of 1 and 16 slots, resident, and
# of 32, streamed through 23
SPLIT_CASES = ((131072, 2, 6), (131072, 128, 6), (262144, 2, 6),
               (262144, 128, 6), (524288, 2, 6), (1 << 21, 2, 6),
               (1 << 22, 2, 6), (1 << 24, 1, 6), (131072, 2, 1),
               (131072, 2, 16), (131072, 2, 32))


def phase_kernel() -> float:
    """The one-cluster route's worst error."""
    from glava_tpu_torch.ops import fused

    rng = np.random.default_rng(0)
    worst = {}
    for n, B, F in FUSED_CASES:
        err = _case(n, B, F, rng)
        plan = fused.fft_plan(n)
        key = f"n{n} (k {plan.k}{', streamed' if plan.slots(F) < F else ''})"
        worst[key] = max(worst.get(key, 0.0), err)
    print(f"[3 kernel] fused_update vs plain over B in {{1, 2, 128}}, F in "
          f"{{1, 6, 16}} (and F 24 at n 16384), 8 updates each, untouched "
          f"history slots torch.equal; max abs err by n: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())} "
          f"(tolerance {TOL})")
    return max(worst.values())


def phase_split() -> float:
    """The split route's worst error over ``SPLIT_CASES``."""
    from glava_tpu_torch.ops import fused

    rng = np.random.default_rng(0)
    split = {}
    for n, B, F in SPLIT_CASES:
        before = fused.split_launches
        plan = fused.fft_plan(n)
        key = (f"n{n} B{B} F{F} (k {plan.k}, run {plan.split_run}, "
               f"{plan.split_copy}, {plan.split_slots(F)} slots resident)")
        split[key] = _case(n, B, F, rng, updates=4)
        if fused.split_launches != before + 4:
            raise AssertionError(f"split n{n} B{B}: {fused.split_launches - before} "
                                 "split launches for 4 updates")
    print(f"[3 kernel] fused_update split route (k = n/4096 column FFTs of "
          f"2048 points, then the k-point stage and the epilogue) vs plain, "
          f"4 updates of fresh audio each, one split launch an update, "
          f"untouched history slots torch.equal; max abs err: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in split.items())} "
          f"(tolerance {TOL}, or the plain version's distance from a "
          f"float64 model where larger)")
    return max(split.values())


def _module_lookup(module: str, screen, reqs=()):
    """The StaticLookup a module builds (its real index plane)."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(cli_requests=reqs, force_module=module),
                 screen=screen, device="cuda")
    (lk,) = r.module.lookups
    return lk


def phase_lookup() -> float:
    """table_lookup vs table_lookup_plain, bit for bit."""
    from glava_tpu_torch.ops import lookup

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    radial = _module_lookup("radial", (1920, 1080))
    circle = _module_lookup("circle", (1920, 1080))
    if radial.table_size != 162 or circle.table_size != 8192:
        raise AssertionError(f"tables {radial.table_size}, {circle.table_size}")
    cases = {
        "radial T162 1920x1080": (radial.table_size, radial.idx),
        "circle T8192 3x1920x1080": (circle.table_size, circle.idx),
        "T32768 dyn smem 2x40000": (32768, t(rng.integers(
            0, 32768, (2, 40000)).astype(np.int32))),
        "T131072 from the L2 2M": (131072, t(rng.integers(
            0, 131072, 2_000_000).astype(np.int32))),
        "T8192 random 2M": (8192, t(rng.integers(
            0, 8192, 2_000_000).astype(np.int32))),
        "T256 97 points": (256, t(rng.integers(0, 256, 97).astype(np.int32))),
    }
    worst = 0.0
    names = []
    for name, (T, idx) in cases.items():
        for S in (None, 3):
            tab = t(rng.standard_normal((T,) if S is None else (S, T))
                    .astype(np.float32))
            got = lookup.table_lookup(tab, idx)
            want = lookup.table_lookup_plain(tab, idx)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"table_lookup {name} S={S}: kernel != plain")
            worst = max(worst, (got - want).abs().max().item())
        names.append(name)
    try:
        bad = np.zeros((8, 8), np.int64)
        bad[3, 5] = 162
        lookup.StaticLookup(bad, 162, dev)
    except ValueError:
        pass
    else:
        raise AssertionError("an out-of-range static plane did not raise")
    print(f"[3 kernel] table_lookup vs plain, torch.equal on (T,) and (3, T) "
          f"tables: {'; '.join(names)}; max abs err {worst}; an out-of-range "
          "static plane raises at build")
    return worst


LATCH_SHAPE = (1081, 1920)   # a 1080p walk's rows [-1, h) x columns
# the 1080p and 800x600 walks, odd and degenerate planes, and a plane
# taller than one of the kernel's row super-blocks (1280 rows)
LATCH_SHAPES = (LATCH_SHAPE, (601, 800), (97, 131), (1, 7), (7, 1), (4097, 96))


def latch_inputs(C: int, reverse: bool, seed: int = 5, shape=LATCH_SHAPE,
                 worse: float = 0.0):
    """A first-hit key plane (``2*row + type`` at 15% of the cells, the
    sentinel elsewhere, the last column event-free; with ``worse`` that
    share of the cells keyed worse than the sentinel) and C candidate
    planes on the card."""
    rng = np.random.default_rng(seed)
    E, W = shape
    sent = float(np.float32(1 << 30)) if reverse else -1.0
    rows = np.arange(E, dtype=np.int64)[:, None]
    event = rng.random((E, W)) < 0.15
    event[:, -1] = False
    key = np.where(event, 2 * rows + rng.integers(0, 2, (E, W)), sent)
    key = np.where(rng.random((E, W)) < worse, 2 ** 31 if reverse else -2, key)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device="cuda")  # noqa: E731
    return t(key), tuple(t(rng.standard_normal((E, W))) for _ in range(C)), sent


def phase_latch() -> float:
    """latch_scan vs latch_scan_plain, bit for bit, one launch a call."""
    from glava_tpu_torch.ops import latch

    cases = [(shape, 0.0) for shape in LATCH_SHAPES] + [(LATCH_SHAPE, 0.3)]
    for C in (0, 4):
        for reverse in (True, False):
            for shape, worse in cases:
                key, cands, sent = latch_inputs(C, reverse, shape=shape,
                                                worse=worse)
                before = latch.launches[C]
                got = latch.latch_scan(key, cands, reverse, sent)
                want = latch.latch_scan_plain(key, cands, reverse, sent)
                torch.cuda.synchronize()
                if latch.launches[C] != before + 1 or not all(
                        torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"latch_scan {shape} C={C} reverse="
                                         f"{reverse} worse={worse}: kernel != "
                                         "plain")
    print(f"[3 kernel] latch_scan vs plain, torch.equal on every output, C in "
          f"{{0, 4}}, suffix min and prefix max, at "
          f"{', '.join(map(str, LATCH_SHAPES))} and {LATCH_SHAPE} with 30% of "
          "keys worse than the sentinel; max abs err 0.0")
    return 0.0


ROWWISE_SHAPE = (1920, 1080, 1080)   # N = W columns, T = P = H rows
# index planes of the row-wise lookup's checks and times: "uniform" one
# index at every point, "constant" one index a table row (a fetch at a
# walk result), "monotone" rising along the points (a fetch at an
# audio-driven row), "random" uniformly drawn
ROWWISE_PATTERNS = ("uniform", "constant", "monotone", "random")
# (label, (N, T, P), layout, pattern) at C in {1, 4}: every pattern on
# the interpreter's .T views at 1080p; contiguous operands; views that
# start off a 16-byte boundary; tables that are one column broadcast
# (stride 0, the interpreter's const x pattern); odd shapes; T = 1;
# 2160 rows (a strip of 8 rows); and tables too tall for shared memory
# (the direct route, over several bands of points)
ROWWISE_CASES = tuple(
    (f"1080p {p}", ROWWISE_SHAPE, "T views", p) for p in ROWWISE_PATTERNS
) + (
    ("1080p contiguous", ROWWISE_SHAPE, "contiguous", "random"),
    ("1080p offset views", ROWWISE_SHAPE, "offset views", "random"),
    ("1080p broadcast table", ROWWISE_SHAPE, "broadcast", "monotone"),
    ("97x131", (97, 131, 131), "T views", "random"),
    ("97x131 contiguous", (97, 131, 131), "contiguous", "monotone"),
    ("T 1", (5, 1, 7), "T views", "uniform"),
    ("T 2160", (256, 2160, 2160), "T views", "random"),
    ("T 8192", (96, 8192, 1000), "T views", "random"),
    ("T 9001 contiguous", (97, 9001, 777), "contiguous", "random"),
)


def rowwise_inputs(C: int, layout: str = "T views", pattern: str = "random",
                   shape=ROWWISE_SHAPE, seed: int = 6):
    """C (N, T) float32 tables and an (N, P) int32 index plane on the
    card. ``layout``: "T views" (``.T`` views of (H, W) planes, as the
    interpreter's column fetch passes them), "contiguous", "offset
    views" (``.T`` views of planes cut from wider ones, starting 3 and
    5 elements in) or "broadcast" (``.T`` views whose tables are one
    plane column expanded, row stride 0, and a .T index plane)."""
    rng = np.random.default_rng(seed)
    N, T, P = shape
    if pattern == "uniform":
        idx = np.full((N, P), rng.integers(T))
    elif pattern == "constant":
        idx = np.broadcast_to(rng.integers(0, T, (N, 1)), (N, P))
    elif pattern == "monotone":
        idx = np.minimum(np.arange(P)[None, :] * T // P
                         + rng.integers(0, 3, (N, 1)), T - 1)
    else:
        idx = rng.integers(0, T, (N, P))
    idx = idx.astype(np.int32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")  # noqa: E731
    planes = [rng.standard_normal((T, N)).astype(np.float32) for _ in range(C)]
    if layout == "contiguous":
        return tuple(t(p.T) for p in planes), t(idx)
    if layout == "offset views":
        wide = lambda a, k: t(np.pad(a, ((0, 0), (k, 0))))[:, k:]  # noqa: E731
        return tuple(wide(p, 3).T for p in planes), wide(idx.T, 5).T
    if layout == "broadcast":
        return (tuple(t(p)[:, :1].expand(T, N).T for p in planes), t(idx.T).T)
    return tuple(t(p).T for p in planes), t(idx.T).T


def phase_rowwise() -> float:
    """rowwise_lookup vs rowwise_lookup_plain, bit for bit, on every
    ``ROWWISE_CASES`` entry at C in {1, 4}: one launch a call, on the
    route ``rowwise_plan`` gives; each route and strip width seen."""
    from glava_tpu_torch.ops import lookup

    names = []
    seen = set()
    for C in (1, 4):
        for label, shape, layout, pattern in ROWWISE_CASES:
            tabs, idx = rowwise_inputs(C, layout, pattern, shape)
            plan = lookup.rowwise_plan(C, shape[1], shape[2], idx.stride())
            before = (lookup.rowwise_launches[C], lookup.rowwise_routes[plan.route])
            got = lookup.rowwise_lookup(tabs, idx)
            want = lookup.rowwise_lookup_plain(tabs, idx)
            torch.cuda.synchronize()
            after = (lookup.rowwise_launches[C], lookup.rowwise_routes[plan.route])
            if after != (before[0] + 1, before[1] + 1) or not all(
                    g.shape == w.shape and torch.equal(g, w)
                    for g, w in zip(got, want)):
                raise AssertionError(f"rowwise_lookup C={C} {label}: kernel != "
                                     f"plain or not one {plan.route} launch")
            seen.add((C, plan.route, plan.strip))
            names.append(f"C{C} {label} ({plan.route} {plan.strip})")
    if seen != {(C, r, s) for C in (1, 4) for r, s in (
            ("staged", 16), ("staged", 8), ("direct", 16))}:
        raise AssertionError(f"rowwise_lookup: routes checked {sorted(seen)}")
    print(f"[3 kernel] rowwise_lookup vs plain, torch.equal, one launch a call "
          f"(case, route): {'; '.join(names)}; max abs err 0.0")
    return 0.0


# (name, streams, rows, columns): the fleet's frames, and one stream of
# MIRROR_YX at 1080p, whose raster runs at (rows, columns) = (W, H) and
# is read through the transposed view
RASTER_CASES = (("S64 800x600", 64, 600, 800), ("S64 1920x1080", 64, 1080, 1920),
                ("S1 1920x1080 MIRROR_YX", 1, 1920, 1080))


def raster_inputs(S: int, H: int, W: int, shared: bool, seed: int = 7):
    """bars_raster inputs on the card: bar heights up to the frame's
    height with a fifth of the columns at -inf (gaps), an inner mask,
    half-pixel row distances and (1 or S, H, 4) colour tables."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    v = rng.uniform(-10.0, H, (S, W)).astype(np.float32)
    v[:, rng.random(W) < 0.2] = -np.inf
    L = 1 if shared else S
    return (t(v), t(rng.random(W) < 0.6), t(np.arange(H, dtype=np.float32) + 0.5),
            t(rng.random((L, H, 4)).astype(np.float32)),
            t((rng.random((L, H, 4)) * 1.5).astype(np.float32)))


def phase_raster() -> float:
    """bars_raster vs bars_raster_plain, bit for bit."""
    from glava_tpu_torch.ops import raster

    cases = []
    for name, S, H, W in RASTER_CASES:
        for shared in (False, True):
            args = raster_inputs(S, H, W, shared)
            for outlined in (True, False):
                got = raster.bars_raster(*args, 1.0, outlined)
                want = raster.bars_raster_plain(*args, 1.0, outlined)
                torch.cuda.synchronize()
                if name.endswith("MIRROR_YX"):
                    got, want = got.transpose(-1, -2), want.transpose(-1, -2)
                if got.shape != want.shape or not torch.equal(got, want):
                    raise AssertionError(f"bars_raster {name} shared={shared} "
                                         f"outlined={outlined}: kernel != plain")
                del got, want
            cases.append(f"{name}/{'shared' if shared else 'per-stream'}")
    print(f"[3 kernel] bars_raster vs plain, torch.equal with and without the "
          f"outline: {', '.join(cases)}; max abs err 0.0")
    return 0.0


# (sz, ratio, distance) of the smooth transform's checks: the shipped
# bufsize and the largest, the default ratio and the whole row, the
# default distance and a wide one
SMOOTH_CASES = tuple((sz, ratio, d) for sz in (4096, 65536)
                     for ratio in (4.0, 1.0) for d in (0.01, 0.5))
SMOOTH_TOL = 1e-5    # the JAX suite's oracle tolerance (tests/test_ops.py)


def smooth_rows(sz: int, rows: int, seed: int) -> np.ndarray:
    """Rows in [-1, 1] with about 20% exact zeros; row 0 opens on 64
    zeros (empty windows: NaNs that propagate, then 0)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (rows, sz)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.2] = 0.0
    x[0, :64] = 0.0
    return x


def smooth_live_rows(sz: int, n: int) -> list[np.ndarray]:
    """n (1, sz) inputs, row 1 of ``smooth_rows(sz, 2, seed)`` for seed
    0, 1, ..., passing over a row whose bin 1 window [1, 2] holds two
    zeros: so every smoothed bin is finite and walked as on the main
    path (an empty first window, as row 0's, is NaN, and every later
    window holds the bin before it: the whole row NaN, then 0).
    ``_check_live`` holds the outputs to that."""
    rows = []
    seed = 0
    while len(rows) < n:
        x = smooth_rows(sz, 2, seed)[1:]
        if x[0, 1] != 0 or x[0, 2] != 0:
            rows.append(x)
        seed += 1
    return rows


def _check_live(out: torch.Tensor, asz: int, what: str) -> None:
    """Every smoothed bin of ``out`` nonzero: no window came out empty
    or NaN (both give 0), so a time taken on its input is one of finite
    means."""
    dead = int((out[..., 1:asz] == 0).sum())
    if dead:
        raise AssertionError(f"{what}: {dead} of the {asz - 1} smoothed bins "
                             "came out 0 (a NaN or empty window): not a "
                             "live row")


# row 1 of a 2-row sz 4096 input (ratio 4, d 0.01) forcing one branch of
# the kernel's walks, row 0 as smooth_rows makes it (its empty first
# window makes it all NaN, then 0): case -> the rows the exact walk must
# finish (tests/test_torch_cpu_path.py holds the same cases in its numpy
# model of the walks)
SMOOTH_BRANCHES = {
    "cancellation": 1,      # bin 1's window [1, 2] sums to 0
    "posinf": 1,            # the windows from one holding x[600] = +inf
    "neginf": 1,
    "nan": 0,               # a NaN input poisons its windows, fast walk
    "silent": 0,            # an all-zero row (both rows): every bin 0
    "distance0": 2,         # d 0: lo jumps by 2, both rows walk exactly
}
# where those cases put their input +-inf or NaN in row 1
SMOOTH_BRANCH_AT = {"posinf": 600, "neginf": 600, "nan": 300}


def smooth_branch_rows(case: str) -> np.ndarray:
    x = smooth_rows(4096, 2, 41)
    if case == "cancellation":
        x[1, 1], x[1, 2] = 0.5, -0.5
    elif case in SMOOTH_BRANCH_AT:
        x[1, SMOOTH_BRANCH_AT[case]] = {"posinf": np.inf, "neginf": -np.inf,
                                        "nan": np.nan}[case]
    elif case == "silent":
        x[:] = 0.0
    return x


def _branch_effect(case: str, got: torch.Tensor, d: float) -> None:
    """What the branch must do to row 1 beyond matching the plain
    version: an input +-inf gives that inf from the first window holding
    it to the last smoothed bin (each window holds the bin before it)
    and finite bins before; a NaN gives a run of 0 there; a cancellation
    gives bin 1 exactly 0; a silent row all 0."""
    from glava_tpu_torch.ops import smooth

    row = got[1].cpu()
    b = smooth.smooth_bounds(row.shape[-1], 4.0, d)
    if case in SMOOTH_BRANCH_AT:
        t0 = int(np.flatnonzero(b[:, 1] >= SMOOTH_BRANCH_AT[case])[0])
        tail, head = row[t0:len(b)], row[1:t0]
        want = {"posinf": float("inf"), "neginf": float("-inf"), "nan": 0.0}
        ok = bool((tail == want[case]).all()) and bool(
            (torch.isfinite(head) & (head != 0)).all())
    elif case == "cancellation":
        ok = float(row[1]) == 0.0 and bool(torch.isfinite(row[:len(b)]).all())
    elif case == "silent":
        ok = bool((got == 0).all())
    else:
        ok = True
    if not ok:
        raise AssertionError(f"smooth_scan {case}: row 1 lacks the branch's "
                             "mark (inf run, zero run or bin 1 = 0)")


def _smooth_check(label: str, x: torch.Tensor, ratio: float, d: float,
                  exact_rows: int, exact_from=None) -> float:
    """One launch of the kernel on ``x`` against the plain version (zero
    positions identical, values within SMOOTH_TOL) whose exact walk
    must finish ``exact_rows`` rows, through the wrapper (or, given
    ``exact_from``, every row handed to the exact walk from that bin);
    returns the max abs error over the finite values and the output."""
    from glava_tpu_torch.ops import smooth

    smooth.reset_rows_by_walk()
    n0 = smooth.launches
    got = smooth.smooth_transform(x, ratio, d) if exact_from is None \
        else smooth._launch(x, ratio, d, exact_from)
    torch.cuda.synchronize()
    want = smooth.smooth_transform_plain(x, ratio, d)
    torch.cuda.synchronize()
    # +-inf pass through: the same infs, the finite values within the
    # tolerance
    fin = torch.isfinite(want)
    same_inf = torch.equal(torch.isfinite(got), fin) and torch.equal(
        got[~fin], want[~fin])
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    walks = smooth.rows_by_walk()
    rows = x.numel() // x.shape[-1]
    if smooth.launches != n0 + 1 or not torch.equal(got == 0, want == 0) \
            or not same_inf or not err <= SMOOTH_TOL \
            or walks != {"fast": rows - exact_rows, "exact": exact_rows}:
        raise AssertionError(f"smooth_scan {label}: {smooth.launches - n0} "
                             f"launches, zeros equal "
                             f"{torch.equal(got == 0, want == 0)}, infs equal "
                             f"{same_inf}, max abs err {err} (tolerance "
                             f"{SMOOTH_TOL}), rows by walk {walks}, "
                             f"{exact_rows} exact expected")
    return err, got


def phase_smooth() -> float:
    """smooth_scan vs its plain version on the card, one launch a call:
    the zero positions (NaN -> 0 and the input's zeros) identical, the
    values within SMOOTH_TOL, at every SMOOTH_CASES shape on the fast
    walk and again with every row on the exact walk from bin 1; then
    each SMOOTH_BRANCHES case, whose rows must take the walk it names.
    The wrapper's table size must be the kernel's own."""
    import ctypes

    from glava_tpu_torch.ops import _build, smooth

    nbytes = _build.load("smooth_scan").lib.glava_smooth_scan_bytes
    nbytes.argtypes = [ctypes.c_int, ctypes.c_int]
    nbytes.restype = ctypes.c_longlong
    for sz, ratio, _ in SMOOTH_CASES + ((300, 3.0, 0.2), (1, 1.0, 0.01)):
        asz = -(-sz // int(ratio))
        if nbytes(sz, asz) != smooth.table_bytes(sz, asz):
            raise AssertionError(f"smooth_scan tables at sz {sz}, asz {asz}: "
                                 f"kernel {nbytes(sz, asz)} bytes, wrapper "
                                 f"{smooth.table_bytes(sz, asz)}")
    worst = 0.0
    lines = []
    for sz, ratio, d in SMOOTH_CASES:
        x = torch.as_tensor(smooth_rows(sz, 2, sz + int(ratio)), device="cuda")
        label = f"sz {sz} r {ratio:g} d {d:g}"
        fast = _smooth_check(label, x, ratio, d, 0)[0]
        exact = _smooth_check(f"{label}, exact from bin 1", x, ratio, d, 2,
                              1)[0]
        worst = max(worst, fast, exact)
        lines.append(f"{label}: fast {fast:.2e}, exact {exact:.2e}")
    print(f"[3 kernel] smooth_scan vs plain, 2 rows, one launch a call, zero "
          f"positions equal; max abs err on the fast walk (both rows) and "
          f"the exact walk from bin 1 (both rows): {'; '.join(lines)} "
          f"(tolerance {SMOOTH_TOL}; tables of rows of 65536 in device "
          f"memory)")
    lines = []
    for case, exact in SMOOTH_BRANCHES.items():
        x = torch.as_tensor(smooth_branch_rows(case), device="cuda")
        d = 0.0 if case == "distance0" else 0.01
        err, got = _smooth_check(case, x, 4.0, d, exact)
        _branch_effect(case, got, d)
        worst = max(worst, err)
        lines.append(f"{case}: {err:.2e}, rows fast {2 - exact} exact {exact}")
    print(f"[3 kernel] smooth_scan branches in row 1, sz 4096 r 4 d 0.01, "
          f"2 rows, zero positions and infs equal, row 1's inf or zero run "
          f"where the case puts it, rows by walk as expected: "
          f"{'; '.join(lines)}")
    return worst


WHILE_SHAPES = ((1080, 1920), (600, 800), (97, 131), (1, 7))
WHILE_CAP = 10


def _while_plane(shape, where: str) -> torch.Tensor:
    if where == "many":
        return torch.rand(shape, device="cuda") < 0.3
    a = torch.zeros(shape, dtype=torch.bool, device="cuda")
    if where != "none":
        a.view(-1)[0 if where == "first" else -1] = True
    return a


def _while_loop(n_t: torch.Tensor, nested: bool):
    """A loop whose trip count the device tensor ``n_t`` sets (x counts
    up to n_t per element, an inner loop in each iteration when
    ``nested``) through ``graph_while.run`` -> (x, fuel), its state."""
    from glava_tpu_torch.ops import graph_while

    x = torch.zeros(4, device="cuda")
    act = torch.zeros(16, dtype=torch.bool, device="cuda")
    fuel = torch.zeros(1, dtype=torch.int32, device="cuda")
    act[:4].copy_(x < n_t)

    def body():
        y = x + 1.0
        if nested:
            inner = torch.zeros(4, device="cuda")
            iact = torch.zeros(16, dtype=torch.bool, device="cuda")
            ifuel = torch.zeros(1, dtype=torch.int32, device="cuda")
            iact[:4].copy_(inner < 2.0)

            def ibody():
                inner.add_(torch.where(iact[:4], 1.0, 0.0))
                iact[:4].copy_(iact[:4] & (inner < 2.0))
                ifuel.add_(1)

            graph_while.run(iact, ifuel, 100, ibody)
            y = x + inner * 0.5
        x.copy_(torch.where(act[:4], y, x))
        act[:4].copy_(act[:4] & (x < n_t))
        fuel.add_(1)

    graph_while.run(act, fuel, 100, body)
    return x, fuel


def _while_node_check() -> str:
    """A loop and a loop nested in it, each captured once into a CUDA
    graph (a while node, the nested one inside its body) and replayed at
    trip counts a device tensor sets, under ``sync_errors``, against the
    same loop run from the host; the fuel cap stops a loop that would
    run on."""
    from glava_tpu_torch import compiled

    out = []
    for nested in (False, True):
        n_t = torch.zeros(4, device="cuda")
        step = compiled.Step("cuda", {})
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=pool, stream=torch.cuda.Stream(),
                              capture_error_mode="thread_local"), \
                compiled._body_of(step, "capture", pool):
            x, fuel = _while_loop(n_t, nested)
        trips = []
        for vals in ([5, 9, 0, 3], [1, 2, 30, 4], [0, 0, 0, 0],
                     [500, 9, 0, 3]):
            n_t.copy_(torch.tensor(vals, dtype=torch.float32))
            with sync_errors():
                graph.replay()
            ex, ef = _while_loop(n_t, nested)
            if not (torch.equal(x, ex) and torch.equal(fuel, ef)):
                raise AssertionError(
                    f"while node{' (nested)' if nested else ''} at {vals}: "
                    f"replay x {x.tolist()} fuel {fuel.item()}, host-driven "
                    f"x {ex.tolist()} fuel {ef.item()}")
            trips.append(int(fuel.item()))
        if trips != [9, 30, 0, 100]:
            raise AssertionError(f"while node trips {trips}")
        out.append(f"{'nested ' if nested else ''}trips {trips}")
    return ", ".join(out)


def _setter_err() -> float:
    """The largest difference of the while setter from its plain
    version (``condition_plain``) on every ``WHILE_SHAPES`` plane with
    no pixel active, the first, the last and many, the fuel below and
    at the cap; raises if a launch leaves its sync words set."""
    from glava_tpu_torch.ops import graph_while

    err = 0.0
    for shape in WHILE_SHAPES:
        for where in ("none", "first", "last", "many"):
            a = _while_plane(shape, where)
            for f in (0, WHILE_CAP - 1, WHILE_CAP):
                fuel = torch.full((1,), f, dtype=torch.int32, device="cuda")
                sync = torch.zeros(2, dtype=torch.int32, device="cuda")
                go = torch.full((1,), -1, dtype=torch.int32, device="cuda")
                graph_while.set_condition(a, fuel, WHILE_CAP, sync, go)
                want = graph_while.condition_plain(a, fuel, WHILE_CAP)
                err = max(err, abs(float(go[0]) - float(want)))
                if bool(sync.any()):
                    raise AssertionError(f"while setter {shape} {where}: "
                                         f"sync words left {sync.tolist()}")
    return err


def _setter_profile(fn, calls: int) -> tuple[float, float]:
    """The while setter's launches a call of ``fn`` and device us a
    launch, by torch.profiler over ``calls`` calls (inside a graph's
    replay, each launch of the setter a kernel of its own)."""
    from glava_tpu_torch.utils.timing import _profiled

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    rows = [e for e in _profiled(fn, calls) if "while_set_kernel" in e.key]
    n = sum(e.count for e in rows)
    if not n:
        raise AssertionError("the profile recorded no while setter launch")
    return n / calls, sum(e.self_device_time_total for e in rows) / n


WHILE_TRIPS = 30


def _setter_in_replay(replays: int = 20) -> tuple[float, float]:
    """The while setter inside replays of a captured loop of
    ``WHILE_TRIPS`` iterations over a 1920x1080 active plane (the body
    one elementwise kernel that clears the plane at the last trip):
    (setter launches a replay, device us a launch), torch.profiler."""
    from glava_tpu_torch import compiled
    from glava_tpu_torch.ops import graph_while
    from glava_tpu_torch.utils.timing import _profiled

    act = torch.ones((1080, 1920), dtype=torch.bool, device="cuda")
    fuel = torch.zeros(1, dtype=torch.int32, device="cuda")
    trips = torch.full((1,), WHILE_TRIPS, dtype=torch.int32, device="cuda")

    def body():
        fuel.add_(1)
        act.copy_((fuel < trips).expand(act.shape))

    # the profiler sees a conditional node's body kernels only in graphs
    # made after its first session in the process (torch 2.11, CUDA 12.8)
    _profiled(lambda: fuel.add_(0), 1)
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    with torch.cuda.graph(graph, pool=pool, stream=torch.cuda.Stream(),
                          capture_error_mode="thread_local"), \
            compiled._body_of(compiled.Step("cuda", {}), "capture", pool):
        graph_while.run(act, fuel, 1000, body)

    def replay():
        act.fill_(True)
        fuel.zero_()
        graph.replay()

    replay()
    if int(fuel.item()) != WHILE_TRIPS or bool(act.any()):
        raise AssertionError(f"the timed while node ran {int(fuel.item())} "
                             f"trips, expected {WHILE_TRIPS}")
    n, us = _setter_profile(replay, replays)
    if n != WHILE_TRIPS + 1:
        raise AssertionError(f"the profile shows {n} while setter launches "
                             f"a replay, expected {WHILE_TRIPS + 1}")
    return n, us


def phase_while(card: str) -> float:
    """The while setter (``graph_while.set_condition``) against its plain
    version (``_setter_err``); then ``_while_node_check``; then its time
    by CUDA events on fresh 1920x1080 planes and by torch.profiler
    inside replays of a captured loop (``_setter_in_replay``)."""
    err = _setter_err()
    if err:
        raise AssertionError(f"while setter differs from its plain version "
                             f"by {err}")
    node = _while_node_check()
    print(f"[3 kernel] graph_while setter vs plain, equal on {len(WHILE_SHAPES)} "
          f"plane shapes x 4 patterns x 3 fuels; while node replays equal to "
          f"the host-driven loop: {node}")
    ev = _while_times()["ms"] * 1e3
    n, us = _setter_in_replay()
    print(f"[3 kernel] graph_while setter on 1920x1080 planes, no pixel "
          f"active: {ev:.2f} us a launch by CUDA events (32 planes in turn); "
          f"{us:.2f} us a launch by torch.profiler inside replays of a "
          f"{WHILE_TRIPS}-trip loop ({n:.0f} launches a replay) ({card})")
    return err


def _fixed_frame(device: str, screen=None, reqs=(), module="bars",
                 user_dir=None, with_renderer: bool = False):
    """The final uint8 frame of 24 updates of fixed stereo tones
    (tests/test_golden.py's input) through the shipped rc.glsl (and the
    renderer that drew it, ``with_renderer``)."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    lc = loader.load(cli_requests=reqs, force_module=module, user_dir=user_dir)
    r = Renderer(lc, screen=screen, device=device)
    cfg = lc.cfg
    state = r.init_state()
    g = float(np.float32(cfg.gravity_step / cfg.nominal_ups))
    frame = None
    for k in range(24):
        state, frame = r.step_u8(state, tone_snapshot(cfg, k), True, 0.25,
                                 1.0, g)
    return (frame.cpu().numpy(), r) if with_renderer else frame.cpu().numpy()


def _cpu_path_frame(device: str, reqs, with_renderer: bool = False):
    """The final uint8 frame of 24 frames of the shipped rc.glsl on the
    CPU path (``reqs``), fixed stereo tones arriving every other frame
    and an interpolation phase of 0.5 between."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(cli_requests=reqs), device=device)
    cfg = r.cfg
    state = r.init_state()
    g = float(np.float32(cfg.gravity_step / cfg.nominal_ups))
    for k in range(24):
        state, frame = r.step_u8(state, tone_snapshot(cfg, k // 2), k % 2 == 0,
                                 0.25, 0.5 if k % 2 else 1.0, g)
    frame = frame.cpu().numpy()
    return (frame, r) if with_renderer else frame


def tone_snapshot(cfg, k: int) -> np.ndarray:
    """The (2, bufsize) ring after k + 1 hops of fixed stereo tones (440
    and 3000 Hz at 0.4), tests/test_golden.py's input."""
    tt = np.arange(cfg.sample_rate) / cfg.sample_rate
    end = (k % (cfg.sample_rate // cfg.hop) + 1) * cfg.hop
    snap = np.zeros((2, cfg.bufsize), np.float32)
    for ch, f in enumerate((440.0, 3000.0)):
        seg = (0.4 * np.sin(2 * np.pi * f * tt[max(end - cfg.bufsize, 0):end]))
        snap[ch, cfg.bufsize - len(seg):] = seg.astype(np.float32)
    return snap


def _counts() -> dict:
    from glava_tpu_torch.ops import (
        fused, graph_while, latch, lookup, raster, smooth,
    )

    counts = {"fused_update": fused.launches,
              "fused_update split": fused.split_launches,
              "table_lookup": lookup.launches,
              "bars_raster": raster.launches, "smooth_scan": smooth.launches,
              "graph_while": graph_while.launches}
    counts.update({f"rowwise_lookup C={C}": n
                   for C, n in lookup.rowwise_launches.items()})
    counts.update({f"latch_scan C={C}": n for C, n in latch.launches.items()})
    return counts


def _zero_counts() -> None:
    from glava_tpu_torch.ops import (
        fused, graph_while, latch, lookup, raster, smooth,
    )

    fused.launches = fused.split_launches = graph_while.launches = 0
    lookup.launches = raster.launches = smooth.launches = 0
    smooth.reset_rows_by_walk()
    lookup.rowwise_launches = dict.fromkeys(lookup.rowwise_launches, 0)
    lookup.rowwise_routes = dict.fromkeys(lookup.rowwise_routes, 0)
    latch.launches = dict.fromkeys(latch.launches, 0)


def _data_launches(name: str, counts: dict, want: dict) -> None:
    """Kernels whose launches the data sets (``DATA_LAUNCHES``): each
    must have launched, and is then expected at its count."""
    for k in DATA_LAUNCHES.get(name, ()):
        if counts[k] == 0:
            raise AssertionError(f"{name}: no {k} launch")
        want[k] = counts[k]


def _engine_run(frames: int, screen=None, module=None, user_dir=None,
                requests=()):
    """One main-path run: the counts are set to 0 just before the run
    and read just after it. fused_update launches once an audio update
    of a module with an fft uniform, never on the CPU path (its route
    the chain) nor for a module without one (``NO_FFT``)."""
    from glava_tpu_torch.ops import lookup, smooth
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    eng = Engine(EngineOptions(audio_backend="synth", screen=screen,
                               force_module=module, user_dir=user_dir,
                               requests=tuple(requests), device="cuda"),
                 sink=NullSink())
    _zero_counts()
    dt = host_ms(lambda i: eng.run(max_frames=frames), 1, warmup=0) / 1e3
    counts = _counts()
    routes = dict(lookup.rowwise_routes)
    name = eng.loaded.module
    w, h = eng.renderer.screen
    if eng.frames_rendered != frames:
        raise AssertionError(f"{name}: engine rendered {eng.frames_rendered} "
                             f"of {frames}")
    # the expectation comes from the run's configuration, not from the
    # route the pipeline chose: the CPU path takes the chain, a module
    # with an fft uniform the fused kernel, and one without none
    cpu_path = "setaccelfft false" in requests
    fft = not cpu_path and name not in NO_FFT
    route = eng.renderer.pipeline.route
    if (cpu_path and route != "chain") or (fft and route != "kernel"):
        raise AssertionError(f"{name} {w}x{h}: update route {route}, expected "
                             f"{'chain' if cpu_path else 'kernel'}")
    want = {k: frames * LAUNCHES[name].get(k, 0) for k in COUNTED}
    want["fused_update"] = eng.updates if fft else 0
    _data_launches(name, counts, want)
    # every row-wise fetch of the smoke's planes (T = h <= 1080) stages
    staged = counts["rowwise_lookup C=1"] + counts["rowwise_lookup C=4"]
    if counts != want or (fft and eng.updates == 0) or routes != {
            "staged": staged, "direct": 0}:
        raise AssertionError(f"{name} {w}x{h}: launches {counts}, routes "
                             f"{routes}, expected {want} ({eng.updates} updates)")
    extra = f" ({', '.join(requests)})" if requests else ""
    walks = ""
    if counts["smooth_scan"]:
        # one row a launch (a stateless uniform of one channel)
        walks = smooth.rows_by_walk()
        if sum(walks.values()) != counts["smooth_scan"]:
            raise AssertionError(f"{name} {w}x{h}: smooth_scan rows by walk "
                                 f"{walks} for {counts['smooth_scan']} launches")
        walks = f", smooth_scan rows by walk {walks}"
    print(f"[4 main path] {name} {w}x{h}{extra}: {frames} frames, {eng.updates} "
          f"updates, update route {eng.renderer.pipeline.route}, launches "
          f"{counts}{f', row-wise routes {routes}' if staged else ''}"
          f"{walks}, {frames / dt:.1f} fps host clock")
    return counts


def _fleet_streams(n: int, loadeds=(None,), pipe: bool = True) -> list:
    """``n`` fleet streams: synth tones (stream i at 110 (i + 1) Hz and
    1.5x that), its own ``fg`` and ``bg`` colours (none when not
    ``pipe``), a null sink; stream i runs ``loadeds[i % len(loadeds)]``
    (None: the engine's own)."""
    from glava_tpu_torch.runtime.fleet import StreamSpec
    from glava_tpu_torch.runtime.sinks import NullSink

    rng = np.random.default_rng(n)
    return [StreamSpec(f"s{i}", source=f"synth:{110 * (i + 1)},{165 * (i + 1)}",
                       sink=NullSink(),
                       pipe={"fg": (*rng.uniform(0.3, 1.0, 3), 1.0),
                             "bg": (*rng.uniform(0.0, 0.5, 3), 1.0)}
                       if pipe else {},
                       loaded=loadeds[i % len(loadeds)])
            for i in range(n)]


# the modules of each kind of fleet run: stream i runs module i mod len
FLEET_KINDS = {"bars": ("bars",), "circle": ("circle",),
               "mixed": ("bars", "radial", "wave"),
               "all": MODULES + ("rings",)}


def _kind_loads(kind: str, user_dir=None, reqs=()) -> list:
    from glava_tpu_torch.config import loader

    return [loader.load(cli_requests=reqs, force_module=m,
                        user_dir=user_dir if m in SHADER_MODULES else None)
            for m in FLEET_KINDS[kind]]


def _fleet_want(kind: str, n: int, frames: int) -> dict:
    """A fleet run's launches (``_block_want`` of its streams' modules)."""
    mods = FLEET_KINDS[kind]
    return _block_want([mods[i % len(mods)] for i in range(n)], frames)


def _block_want(stream_mods: list, frames: int) -> dict:
    """The launches of a fleet (or of one mesh device's block of
    streams) whose stream i runs ``stream_mods[i]``: one fused update a
    frame over every stream, unless no module has an fft uniform; one
    raster a frame for a bars group; one table lookup a frame for a
    radial group and one for a circle group (the (S, 2 sz) tables
    against its static plane); a shader module's per stream."""
    want = dict.fromkeys(COUNTED, 0)
    want["fused_update"] = frames * any(m not in NO_FFT for m in stream_mods)
    want["bars_raster"] = frames * ("bars" in stream_mods)
    want["table_lookup"] = frames * (
        ("radial" in stream_mods) + ("circle" in stream_mods)
        + sum(m in SHADER_MODULES for m in stream_mods))
    return want


def _fleet_run(n: int, frames: int, screen=None, kind: str = "bars",
               user_dir=None) -> dict:
    """One fleet main-path run through ``FleetEngine.run``, per-stream
    pipe values: the counts are set to 0 just before and read just
    after, and must be ``_fleet_want``'s."""
    from glava_tpu_torch.runtime.fleet import FleetEngine

    loads = _kind_loads(kind, user_dir)
    eng = FleetEngine(loads[0], _fleet_streams(n, loads), screen=screen,
                      device="cuda")
    _zero_counts()
    dt = host_ms(lambda i: eng.run(max_frames=frames), 1, warmup=0) / 1e3
    counts = _counts()
    rows = eng.state.chains.count.shape[0]
    want = _fleet_want(kind, n, frames)
    w, h = eng.br.screen
    label = f"{kind} fleet S {n} {w}x{h}"
    if eng.frames_rendered != frames or counts != want or rows != 2 * n:
        raise AssertionError(f"{label}: {eng.frames_rendered} frames, launches "
                             f"{counts}, expected {want}; B {rows}, expected {2 * n}")
    print(f"[4 main path] {label} ({', '.join(FLEET_KINDS[kind])}): {frames} "
          f"frames, fused_update B {rows}, launches {counts}, "
          f"{frames / dt:.1f} fps host clock")
    return counts


def _fleet_parity(kind: str, screen, user_dir, n: int = 64,
                  steps: int = 12) -> str:
    """A fleet of ``n`` streams on the card (stream i running module
    i mod len, its own fg/bg row, fixed tones, staggered clocks) against
    one-stream cpu renders of streams 0, 31, 63 and each module's first
    stream, fed the same inputs: the golden rule each. Returns the
    result line."""
    from glava_tpu_torch.parallel import BatchedRenderer, MixedBatchedRenderer
    from glava_tpu_torch.renderer import Renderer

    mods = FLEET_KINDS[kind]
    loads = _kind_loads(kind, user_dir)
    assign = [i % len(mods) for i in range(n)]
    br = (BatchedRenderer(loads[0], n, screen=screen, device="cuda")
          if len(mods) == 1 else
          MixedBatchedRenderer(loads, assign, screen=screen, device="cuda"))
    cfg = loads[0].cfg
    tt = np.arange(cfg.sample_rate) / cfg.sample_rate
    tones = np.stack([np.stack([0.4 * np.sin(2 * np.pi * 110.0 * (s + 1) * tt),
                                0.4 * np.sin(2 * np.pi * 165.0 * (s + 1) * tt)])
                      for s in range(n)]).astype(np.float32)
    rng = np.random.default_rng(5)
    pipe = {"fg": rng.uniform(0.3, 1.0, (n, 4)).astype(np.float32),
            "bg": rng.uniform(0.0, 0.5, (n, 4)).astype(np.float32)}
    g = np.full(n, cfg.gravity_step / cfg.nominal_ups, np.float32)

    def inputs(k):
        end = (k + 1) * cfg.hop
        snap = np.zeros((n, 2, cfg.bufsize), np.float32)
        seg = tones[..., max(end - cfg.bufsize, 0):end]
        snap[..., cfg.bufsize - seg.shape[-1]:] = seg
        return snap, np.array([k % (1 + s % 3) == 0 for s in range(n)])

    state = br.init_state()
    for k in range(steps):
        snap, mod = inputs(k)
        state, frames = br.step(state, snap, mod, np.zeros(n), np.ones(n), g,
                                pipe, quantize=True)
    frames = frames.cpu().numpy()
    check = sorted({s for s in (0, 31, 63) if s < n}
                   | {assign.index(v) for v in range(len(mods))})
    fracs = {}
    for s in check:
        r = Renderer(_kind_loads(kind, user_dir)[assign[s]], screen=screen,
                     device="cpu")
        st = r.init_state()
        for k in range(steps):
            snap, mod = inputs(k)
            st, f = r.step_u8(st, snap[s], bool(mod[s]), 0.0, 1.0, float(g[s]),
                              {name: v[s] for name, v in pipe.items()})
        fracs[s] = golden_rule(frames[s], f.numpy())
        if fracs[s] >= 0.002:
            raise AssertionError(f"{kind} fleet S {n}: stream {s} "
                                 f"({mods[assign[s]]}) {fracs[s]:.4%} of pixels "
                                 "off its one-stream cpu render")
    if not all((frames[s][..., 3] > 0).any() for s in check):
        raise AssertionError(f"{kind} fleet S {n}: a checked stream drew nothing")
    w, h = br.screen
    return (f"{kind} fleet S {n} {w}x{h}, per-stream fg/bg rows, staggered "
            f"clocks, cuda fleet vs one-stream cpu renders: " + ", ".join(
                f"stream {s} ({mods[assign[s]]}) {fracs[s]:.4%}" for s in check)
            + " px > 2 LSB")


def _fleet_fixed_frames(device: str, n: int = 4) -> np.ndarray:
    """(n, 600, 800, 4) uint8 frames of a bars fleet after 24 steps of
    fixed per-stream tones on staggered clocks, with per-stream colours."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.parallel import BatchedRenderer

    lc = loader.load()
    cfg = lc.cfg
    br = BatchedRenderer(lc, n_streams=n, device=device)
    tt = np.arange(cfg.sample_rate) / cfg.sample_rate
    tones = np.stack([np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (s + 1) * tt),
                                0.4 * np.sin(2 * np.pi * 1500.0 * (s + 1) * tt)])
                      for s in range(n)]).astype(np.float32)
    pipe = {"fg": np.random.default_rng(1).uniform(0.3, 1.0, (n, 4))
            .astype(np.float32)}
    g = np.full(n, cfg.gravity_step / cfg.nominal_ups, np.float32)
    state = br.init_state()
    for k in range(24):
        end = (k + 1) * cfg.hop
        snap = np.zeros((n, 2, cfg.bufsize), np.float32)
        seg = tones[..., max(end - cfg.bufsize, 0):end]
        snap[..., cfg.bufsize - seg.shape[-1]:] = seg
        mods = np.array([k % (s + 1) == 0 for s in range(n)])
        state, frames = br.step(state, snap, mods, np.zeros(n), np.ones(n), g,
                                pipe, quantize=True)
    return frames.cpu().numpy()


RUNS = (
    ("bars", None, 200), ("bars", (1920, 1080), 120),
    ("radial", None, 200), ("radial", (1920, 1080), 120),
    ("circle", None, 200), ("circle", (1920, 1080), 120),
    ("wave", None, 200), ("graph", None, 200),
    ("rings", None, 40), ("rings", (1920, 1080), 20),
    ("aawalk", None, 40), ("aawalk", (1920, 1080), 20),
    ("colfetch", None, 40), ("colfetch", (1920, 1080), 20),
    ("smoothy", None, 40), ("smoothy", (1920, 1080), 20),
    ("audioloop", None, 40), ("audioloop", (1920, 1080), 20),
)

# the CPU path (`setaccelfft false`) of the shipped rc.glsl, keyframe
# interpolation on and off: the chain route, no fused launch
CPU_PATH_RUNS = (("setaccelfft false", "setinterpolate true"),
                 ("setaccelfft false", "setinterpolate false"))


# (module, requests, route) of bufsizes off the shipped 4096 through
# Renderer: 32768 on the fused kernel (clusters of 8 CTAs of 2048-point
# FFTs, the history streamed; circle's table of 2 x 32768 entries read
# from the L2), scaled 128, below the kernel's sizes, on the chain, and
# 131072 on the kernel's split route with the smooth pass off (a user
# smooth_parameters.glsl, NO_SMOOTH_PASS: its dense matrix would take
# 64 GB)
BUFSIZE_REQUESTS = (("bars", ("setbufsize 32768",), "kernel"),
                    ("circle", ("setbufsize 32768",), "kernel"),
                    ("bars", ("setbufsize 4096", "setbufscale 32"), "chain"),
                    ("bars", ("setbufsize 131072", "setsmoothpass false"),
                     "kernel"))
NO_SMOOTH_PASS = "#request setsmoothpass false\n"
# above the fused kernel's largest split plan (2^24): the chain route on
# the card, as the JAX package takes its XLA chain (smooth pass off)
HUGE_BUFSIZE = 1 << 25
TEX_TOL = 5e-5       # textures (the JAX suite's fused-vs-unfused tolerance)


def _huge_update(device: str):
    """One bars-chain update at HUGE_BUFSIZE on ``device`` (fixed noise,
    smooth pass off): (route, textures on the host)."""
    from glava_tpu_torch.config.state import RenderConfig
    from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec

    chain = ("window", "fft", "gravity", "avg")
    p = AudioPipeline(RenderConfig(bufsize=HUGE_BUFSIZE, smooth_pass=False),
                      [UniformSpec("audio_l", "audio_l", chain),
                       UniformSpec("audio_r", "audio_r", chain)],
                      device=device)
    rng = np.random.default_rng(25)
    al, ar = (torch.as_tensor((rng.standard_normal(HUGE_BUFSIZE) * 0.4)
                              .astype(np.float32), device=device)
              for _ in range(2))
    _, tex = p.update(p.init_state(), al, ar)
    return p.route, {k: v.cpu() for k, v in tex.items()}


def phase_huge_bufsize() -> str:
    """An update at HUGE_BUFSIZE takes the chain on the card, no fused
    or split launch, its textures within TEX_TOL of the cpu update's."""
    _zero_counts()
    route, gpu = _huge_update("cuda")
    torch.cuda.synchronize()
    counts = _counts()
    _, cpu = _huge_update("cpu")
    err = max((gpu[k] - cpu[k]).abs().max().item() for k in gpu)
    if route != "chain" or counts["fused_update"] or \
            counts["fused_update split"] or not err <= TEX_TOL:
        raise AssertionError(f"bufsize {HUGE_BUFSIZE}: route {route}, "
                             f"launches {counts}, cuda vs cpu {err}")
    return (f"AudioPipeline bufsize {HUGE_BUFSIZE} (smooth pass off): route "
            f"chain, fused launches {counts['fused_update']}, split "
            f"{counts['fused_update split']}; textures cuda vs cpu max abs "
            f"err {err:.2e} (tolerance {TEX_TOL})")

# (streams, screen, frames, kind): the fleet's main-path runs
FLEET_RUNS = ((64, None, 30, "bars"), (64, (1920, 1080), 8, "bars"),
              (6, None, 30, "mixed"), (64, None, 30, "circle"),
              (64, (1920, 1080), 8, "circle"), (64, None, 6, "all"))
# (kind, screen): fleets held stream by stream against one-stream cpu
# renders
FLEET_PARITY = (("circle", None), ("circle", (1920, 1080)), ("all", None))


# (kind, streams) of the sharded fleets: each runs the unsharded fleet,
# then the same fleet over every SHARD_MESHES mesh; every stream block of
# the bars and mixed fleets holds each of the kind's modules, so each
# device launches what the unsharded fleet launches; the S 8 fleet of
# every native module and rings splits them over its blocks
SHARDED_FLEETS = (("bars", 64), ("mixed", 24), ("all", 8))


def shard_meshes() -> list:
    """(label, devices, make_mesh keywords) of the meshes the sharded
    fleets run on: one card, the first card twice on the streams axis
    and on the rows axis, four times as 2 streams x 2 rows, and every
    card where there are more, on streams and (an even count) on
    rows 2."""
    meshes = [("[cuda:0]", ["cuda:0"], {}),
              ("[cuda:0, cuda:0]", ["cuda:0"] * 2, {}),
              ("[cuda:0] x 2 rows 2", ["cuda:0"] * 2, {"rows": 2}),
              ("[cuda:0] x 4 streams 2 rows 2", ["cuda:0"] * 4,
               {"streams": 2, "rows": 2})]
    count = torch.cuda.device_count()
    cards = [f"cuda:{i}" for i in range(count)]
    if count > 1:
        meshes.append((f"every card [cuda:0 .. cuda:{count - 1}]", cards, {}))
    if count > 1 and count % 2 == 0:
        meshes.append((f"every card [cuda:0 .. cuda:{count - 1}] rows 2",
                       cards, {"rows": 2}))
    return meshes


def _fleet_engine(kind: str, n: int, user_dir, devices=None, screen=None,
                  mesh_kw=None, pipe: bool = True):
    """A FleetEngine of ``n`` streams of ``kind`` (with fg/bg rows
    unless not ``pipe``), on cuda:0 or sharded over a mesh of
    ``devices`` (``make_mesh(devices, **mesh_kw)``)."""
    from glava_tpu_torch.parallel.mesh import make_mesh
    from glava_tpu_torch.runtime.fleet import FleetEngine

    loads = _kind_loads(kind, user_dir)
    mesh = None if devices is None else make_mesh(devices, **(mesh_kw or {}))
    return FleetEngine(loads[0], _fleet_streams(n, loads, pipe), screen=screen,
                       device="cuda", mesh=mesh)


def _sharded_frames(kind: str, n: int, user_dir, devices=None, mesh_kw=None,
                    frames: int = 4):
    """``frames`` fleet frames through ``FleetEngine.step`` and ``fetch``
    on fixed seeded snapshots and staggered clocks (the counts set to 0
    just before, read just after) -> (host frames, counts, engine)."""
    eng = _fleet_engine(kind, n, user_dir, devices, mesh_kw=mesh_kw)
    cfg = eng.loaded.cfg
    rng = np.random.default_rng(31)
    g = np.full(n, cfg.gravity_step / cfg.nominal_ups, np.float32)
    snaps = [(rng.standard_normal((n, 2, cfg.bufsize)) * 0.3).astype(np.float32)
             for _ in range(frames)]
    synchronize()
    _zero_counts()
    out = []
    for k in range(frames):
        mods = np.array([k % (1 + s % 3) == 0 for s in range(n)])
        out.append(eng.fetch(eng.step(snaps[k], mods, 0.25,
                                      np.ones(n, np.float32), g)))
    synchronize()
    return np.stack(out), _counts(), eng


def _replicas_equal(eng) -> int:
    """Each row group's state replicas (one a device of a stream block)
    must be torch.equal; returns the replicas compared."""
    groups: dict = {}
    for (sl, _), st in zip(eng.br.blocks, eng.state):
        groups.setdefault((sl.start, sl.stop), []).append(st)
    pairs = 0
    for key, states in groups.items():
        first = states[0]
        for st in states[1:]:
            for name in ("gravity", "history", "avg", "count"):
                a, b = getattr(first.chains, name), getattr(st.chains, name)
                if not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"streams {key}: the {name} replicas "
                                         "of a row group differ")
            if not torch.equal(first.key_end.cpu(), st.key_end.cpu()):
                raise AssertionError(f"streams {key}: key frames differ")
            pairs += 1
    return pairs


def _band_kernels() -> str:
    """The kernels a rows mesh launches at band shapes, against their
    plain versions, bit for bit: the bars raster at S 64 on each band of
    800x600 and 1920x1080 split in 2 and in 4 (and S 1 under MIRROR_YX,
    the band a slice of the raster's columns), and the table lookup on
    radial's and circle's band index planes, each the whole frame's
    plane cut to the band (circle's widened by its smoothing's row),
    into (64, T) tables."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.ops import lookup, raster
    from glava_tpu_torch.renderer import Renderer

    rng = np.random.default_rng(12)
    shapes, planes = [], []
    for w, h in ((800, 600), (1920, 1080)):
        for rows in (2, 4):
            hb = h // rows
            for S, H, W, view in ((64, hb, w, False), (1, w, hb, True)):
                args = raster_inputs(S, H, W, shared=False)
                for outlined in (True, False):
                    got = raster.bars_raster(*args, 1.0, outlined)
                    want = raster.bars_raster_plain(*args, 1.0, outlined)
                    if not torch.equal(got, want):
                        raise AssertionError(f"bars_raster S {S} ({H}, {W}): "
                                             "kernel != plain")
                shapes.append(f"S{S} ({H}, {W}){' MIRROR_YX' if view else ''}")
        for module in ("radial", "circle"):
            lc = loader.load(force_module=module)
            whole = Renderer(lc, screen=(w, h), device="cuda").module.lookups[0]
            for band in ((0, h // 2), (h // 2, h)):
                lk = Renderer(loader.load(force_module=module), screen=(w, h),
                              device="cuda", rows=band).module.lookups[0]
                a0 = max(band[0] - (module == "circle"), 0)
                a1 = min(band[1] + (module == "circle"), h)
                if not torch.equal(lk.idx, whole.idx[..., a0:a1, :]):
                    raise AssertionError(f"{module} {w}x{h} rows {band}: the "
                                         "band's plane is not the frame's")
                tab = torch.as_tensor(rng.standard_normal(
                    (64, lk.table_size)).astype(np.float32), device="cuda")
                if not torch.equal(lookup.table_lookup(tab, lk.idx),
                                   lookup.table_lookup_plain(tab, lk.idx)):
                    raise AssertionError(f"table_lookup {module} {w}x{h} rows "
                                         f"{band}: kernel != plain")
                planes.append(f"{module} {tuple(lk.idx.shape)}")
    torch.cuda.synchronize()
    return (f"band shapes, kernel vs plain torch.equal: bars_raster "
            f"{', '.join(shapes)}; table_lookup (64, T) tables on the band "
            f"planes {', '.join(planes)} (each the frame's plane cut to its "
            f"band)")


def _per_card_kernels(card: int) -> str:
    """The kernels whose shared-memory opt-in is per device, launched on
    cuda:``card`` against their plain versions: the row-wise lookup's
    staged route at C 4 (bit-identical), the smooth scan at sz 4096 (its
    prefix tables in 123 KB of shared memory; 1e-5, zeros equal), the
    fused update's one-cluster kernel at n 65536 and its split route at
    n 131072 (2e-5)."""
    from glava_tpu_torch.ops import fused, lookup, smooth

    with torch.cuda.device(card):
        tabs, idx = rowwise_inputs(4)
        plan = lookup.rowwise_plan(4, ROWWISE_SHAPE[1], ROWWISE_SHAPE[2],
                                   idx.stride())
        got = lookup.rowwise_lookup(tabs, idx)
        want = lookup.rowwise_lookup_plain(tabs, idx)
        if plan.route != "staged" or got[0].device.index != card or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"cuda:{card}: rowwise_lookup ({plan.route}) "
                                 "differs from its plain version")
        x = torch.as_tensor(smooth_rows(4096, 2, 9), device=f"cuda:{card}")
        got, want = smooth.smooth_transform(x, 4.0, 0.01), \
            smooth.smooth_transform_plain(x, 4.0, 0.01)
        serr = (got - want).abs().max().item()
        if not torch.equal(got == 0, want == 0) or not serr <= SMOOTH_TOL:
            raise AssertionError(f"cuda:{card}: smooth_scan err {serr}")
        rng = np.random.default_rng(card)
        ferr = max(_case(65536, 2, 6, rng, updates=2),
                   _case(131072, 2, 6, rng, updates=2))
        torch.cuda.synchronize()
    return (f"cuda:{card}: rowwise_lookup C 4 staged torch.equal, smooth_scan "
            f"sz 4096 {serr:.2e}, fused_update n 65536 and split n 131072 "
            f"{ferr:.2e}")


def phase_sharded(user_dir: str, totals: dict | None = None) -> list:
    """``FleetEngine(mesh=...)`` of every ``SHARDED_FLEETS`` entry over
    every ``shard_meshes`` mesh, held byte for byte to the unsharded
    fleet, with launch counts the sum over the mesh's devices of what
    the unsharded fleet launches for each device's block of streams
    (added to ``totals``), each row group's state replicas torch.equal
    and a shader module's whole-frame renders counted; then the kernels
    at the rows meshes' band shapes and the per-device kernels on every
    card. Returns the result lines."""
    from glava_tpu_torch import renderer

    meshes = shard_meshes()
    lines = []
    for kind, n in SHARDED_FLEETS:
        want_frames, one, _ = _sharded_frames(kind, n, user_dir)
        mods = FLEET_KINDS[kind]
        if one != _fleet_want(kind, n, 4):
            raise AssertionError(f"{kind} fleet S {n}: launches {one}, "
                                 f"expected {_fleet_want(kind, n, 4)}")
        for label, devices, kw in meshes:
            whole = renderer.whole_frame_bands
            got, counts, eng = _sharded_frames(kind, n, user_dir, devices, kw)
            whole = renderer.whole_frame_bands - whole
            want = dict.fromkeys(COUNTED, 0)
            for sl, _ in eng.br.blocks:
                for k, v in _block_want([mods[i % len(mods)] for i in
                                         range(sl.start, sl.stop)], 4).items():
                    want[k] += v
            rows = eng.br.bands
            # a shader module renders the whole frame on each device of a
            # rows mesh: one a frame a stream of it, in every band
            cut = 4 * sum(mods[i % len(mods)] in SHADER_MODULES
                          for i in range(n)) * len(rows) * (len(rows) > 1)
            if got.tobytes() != want_frames.tobytes() or counts != want \
                    or whole != cut:
                raise AssertionError(
                    f"{kind} fleet S {n} over {label}: frames byte-equal "
                    f"{got.tobytes() == want_frames.tobytes()}, launches "
                    f"{counts}, expected {want}; whole-frame band renders "
                    f"{whole}, expected {cut}")
            replicas = _replicas_equal(eng)
            if totals is not None:
                for k in PATH:
                    totals[k] += counts[k]
            times = len(devices) if counts == {
                k: v * len(devices) for k, v in one.items()} else None
            lines.append(
                f"{kind} fleet S {n} ({', '.join(mods)}) 800x600 sharded over "
                f"{label} (blocks of {n // (len(devices) // len(rows))} "
                f"streams, bands {rows}): 4 frames byte-equal to the unsharded "
                f"fleet's, launches { {k: v for k, v in counts.items() if v} }"
                + (f" = {times} x the unsharded fleet's" if times else
                   " = each device's block's")
                + f", {replicas} state replicas torch.equal"
                + (f", {whole} whole-frame band renders (rings)" if whole
                   else ""))
    lines.append("meshes run: " + "; ".join(label for label, _, _ in meshes))
    lines.append(_band_kernels())
    for card in range(torch.cuda.device_count()):
        lines.append(_per_card_kernels(card))
    if torch.cuda.device_count() == 1:
        lines.append("only one card is visible: the per-device shared-memory "
                     "opt-ins (csrc/rowwise_lookup.cu, csrc/smooth_scan.cu) "
                     "were not exercised on a second card")
    return lines


def phase_main_path(user_dir: str) -> dict:
    from glava_tpu_torch.ops.fused import fft_plan as fused_plan
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    totals = dict.fromkeys(PATH, 0)
    for module, screen, frames in RUNS:
        shader = module in SHADER_MODULES
        counts = _engine_run(frames, screen, module,
                             user_dir if shader else None)
        for k in PATH:
            totals[k] += counts[k]
    for reqs in CPU_PATH_RUNS:
        counts = _engine_run(60, None, "bars", requests=reqs)
        for k in PATH:
            totals[k] += counts[k]
    for n, screen, frames, kind in FLEET_RUNS:
        counts = _fleet_run(n, frames, screen, kind, user_dir)
        for k in PATH:
            totals[k] += counts[k]
    for module, reqs, route in BUFSIZE_REQUESTS:
        # the shipped smooth_parameters.glsl, read after the command
        # line's requests, turns the smooth pass on; a user file after it
        # turns it off again
        ud = None
        if "setsmoothpass false" in reqs:
            ud = Path(user_dir) / "no_smooth_pass"
            ud.mkdir(exist_ok=True)
            (ud / "smooth_parameters.glsl").write_text(NO_SMOOTH_PASS)
        _zero_counts()
        gpu, r = _fixed_frame("cuda", reqs=reqs, module=module, user_dir=ud,
                              with_renderer=True)
        torch.cuda.synchronize()
        counts = _counts()
        split = r.pipeline.route == "kernel" and fused_plan(r.pipeline.sz).split
        want = {k: 24 * LAUNCHES[module].get(k, 0) for k in COUNTED}
        want["fused_update"] = 24 if route == "kernel" and not split else 0
        want["fused_update split"] = 24 if split else 0
        label = (f"{module} 800x600 {', '.join(reqs)} (scaled bufsize "
                 f"{r.pipeline.sz})")
        if r.pipeline.route != route or counts != want or (
                ud is not None and r.cfg.smooth_pass):
            raise AssertionError(f"{label}: route {r.pipeline.route}, launches "
                                 f"{counts}, expected {route} and {want}")
        for k in PATH:
            totals[k] += counts[k]
        frac = golden_rule(gpu, _fixed_frame("cpu", reqs=reqs, module=module,
                                             user_dir=ud))
        if frac >= 0.002 or not (gpu[..., 3] > 0).any():
            raise AssertionError(f"{label} cuda vs cpu: {frac:.4%} off")
        print(f"[4 main path] {label}: update route {route}"
              f"{' (split)' if split else ''} through Renderer, 24 updates, "
              f"launches {counts}; cuda vs cpu {frac:.4%} px > 2 LSB")
    print(f"[4 main path] {phase_huge_bufsize()}")
    for line in phase_sharded(user_dir, totals):
        print(f"[4 main path] {line}")
    if not all(totals.values()):
        raise AssertionError(f"a kernel of the path never launched: {totals}")
    gpu, cpu = _fleet_fixed_frames("cuda"), _fleet_fixed_frames("cpu")
    fracs = [golden_rule(g, c) for g, c in zip(gpu, cpu)]
    if max(fracs) >= 0.002 or not all((g[..., 3] > 0).any() for g in gpu):
        raise AssertionError(f"bars fleet S 4 cuda vs cpu: {fracs} of pixels off")
    print(f"[4 main path] bars fleet S 4 800x600, per-stream colours and "
          f"staggered clocks: cuda vs cpu "
          f"{', '.join(f'{f:.4%}' for f in fracs)} px > 2 LSB")
    for kind, screen in FLEET_PARITY:
        print(f"[4 main path] {_fleet_parity(kind, screen, user_dir)}")
    for reqs in CPU_PATH_RUNS:
        gpu, r = _cpu_path_frame("cuda", reqs, with_renderer=True)
        frac = golden_rule(gpu, _cpu_path_frame("cpu", reqs))
        if r.pipeline.route != "chain" or frac >= 0.002 \
                or not (gpu[..., 3] > 0).any():
            raise AssertionError(f"{', '.join(reqs)}: route {r.pipeline.route}, "
                                 f"cuda vs cpu {frac:.4%} off")
        print(f"[4 main path] bars 800x600 {', '.join(reqs)}: route chain, 24 "
              f"frames, audio every other frame, interp_mod 0.5 between; cuda "
              f"vs cpu {frac:.4%} px > 2 LSB")
    eng = Engine(EngineOptions(audio_backend="synth", test_mode=True,
                               device="cuda"), sink=NullSink())
    if not eng.run_tests():
        raise AssertionError("--run-tests (test_rc.glsl) failed on cuda")
    print("[4 main path] Engine.run_tests() on test_rc.glsl: PASSED on cuda")

    golden = np.load(ROOT / "tests" / "golden" / "frames.npz")
    sizes = {"bars": (192, 128), "radial": (300, 300), "graph": (192, 128),
             "wave": (192, 128), "circle": (300, 300)}   # test_golden.CASES
    for module in MODULES + tuple(SHADER_MODULES):
        ud = user_dir if module in SHADER_MODULES else None
        gpu = _fixed_frame("cuda", module=module, user_dir=ud)
        cpu = _fixed_frame("cpu", module=module, user_dir=ud)
        frac = golden_rule(gpu, cpu)
        if frac >= 0.002 or not (gpu[..., 3] > 0).any():
            raise AssertionError(f"{module} cuda vs cpu 800x600: {frac:.4%} off")
        line = f"{module}: cuda vs cpu 800x600 {frac:.4%} px > 2 LSB"
        if module in sizes:
            w, h = sizes[module]
            small = _fixed_frame("cuda", module=module,
                                 reqs=(f"setgeometry 0 0 {w} {h}",))
            gfrac = golden_rule(small, golden[module])
            if gfrac >= 0.002:
                raise AssertionError(f"{module} {w}x{h} vs golden: {gfrac:.4%} off")
            line += f", {w}x{h} vs golden {gfrac:.4%}"
        print(f"[4 main path] {line}")
    return totals


MEL_SECONDS, MEL_RATE = 30, 16000
MEL_TOL = 2e-5       # relative to the peak (tests/test_mel.py)


def mel_frames() -> np.ndarray:
    """30 s of 16 kHz audio (two tones in noise) framed as Whisper
    frames it: (3001, 512)."""
    from glava_tpu_torch.models import mel

    rng = np.random.default_rng(6)
    t = np.arange(MEL_SECONDS * MEL_RATE) / MEL_RATE
    pcm = (0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 3000.0 * t)
           + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return mel.frame_track(pcm, n_fft=512, hop=160)


def phase_mel() -> None:
    """log_mel on the card against the cpu, within MEL_TOL of the peak."""
    from glava_tpu_torch.models import mel

    frames = mel_frames()
    gpu = mel.log_mel(frames, device="cuda")
    cpu = mel.log_mel(frames, device="cpu")
    gpu = gpu.cpu().numpy()
    err = float(np.abs(gpu - cpu.numpy()).max() / max(np.abs(cpu.numpy()).max(), 1.0))
    if gpu.shape != (frames.shape[0], 80) or not np.isfinite(gpu).all() \
            or err > MEL_TOL:
        raise AssertionError(f"log_mel cuda vs cpu: shape {gpu.shape}, "
                             f"relative err {err} (tolerance {MEL_TOL})")
    print(f"[4 main path] log_mel {MEL_SECONDS} s of {MEL_RATE} Hz audio, "
          f"{frames.shape[0]} frames x {frames.shape[1]} -> {gpu.shape}: cuda vs "
          f"cpu {err:.2e} of the peak (tolerance {MEL_TOL})")


# -- the port's entry points: entry(), dryrun_multichip and the bench ----

DRYRUN_OK = ("dryrun_multichip OK", "dryrun_multichip realistic OK",
             "dryrun_multichip scaling OK", "dryrun_multichip hosts OK",
             "dryrun_multichip engine_4dev OK")
# what the entry-points phase launches of the path's kernels: the fused
# update (every section but log-mel), the table lookup (radial and
# circle, alone and in the fleets) and the bars raster
ENTRY_KERNELS = ("fused_update", "table_lookup", "bars_raster")


def _quantized(frame: torch.Tensor) -> np.ndarray:
    return np.clip(np.rint(frame.cpu().numpy() * 255.0), 0, 255).astype(np.uint8)


def _dryrun(devices, tag: str) -> None:
    """``dryrun_multichip(4, devices)``, its lines printed under ``tag``;
    its five OK lines must come, in order."""
    import io

    from glava_tpu_torch.entry_points import dryrun_multichip

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun_multichip(4, devices)
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"{tag} {line}")
    ok = tuple(ln.split(":")[0] for ln in lines if " OK:" in ln)
    if ok != DRYRUN_OK:
        raise AssertionError(f"dryrun_multichip(4) printed {ok}, expected "
                             f"{DRYRUN_OK}")


def _numbers_ok(line, path: str = "") -> None:
    """Every number of a bench line finite and positive, no ``None``."""
    for k, v in line.items():
        if isinstance(v, dict):
            _numbers_ok(v, f"{path}{k}.")
        elif not isinstance(v, str) and (
                v is None or not np.isfinite(v) or v <= 0):
            raise AssertionError(f"bench {path}{k} = {v}")


def phase_entry_points(card: str) -> None:
    """The port's own entry points on the card, the counts set to 0
    just before and read just after: ``entry()``'s bars frame against
    the same fn on the cpu under the golden rule; ``dryrun_multichip(4)``
    on ``cuda:0`` four times; ``glava_tpu_torch.bench.run()``, the line
    the bench prints, every key there and every number finite and
    positive (the interpreted section ``null`` without the reference's
    shaders in the repository, and the section run on rings at 1080p
    instead). Then, outside the counted run, the spread of the windows
    section's reading over its window length and warm-up."""
    from glava_tpu_torch import bench
    from glava_tpu_torch.entry_points import entry

    _zero_counts()
    fn, args = entry()
    cfn, cargs = entry(device="cpu")
    got, want = _quantized(fn(*args)[1]), _quantized(cfn(*cargs)[1])
    off = golden_rule(got, want)
    if off >= 0.002 or not (got[..., 3] > 0).any():
        raise AssertionError(f"entry(): cuda vs cpu {off:.4%} of pixels off")
    print(f"[4 entry] entry(): bars 512x256 step on cuda vs the same fn on "
          f"cpu: {off:.4%} of pixels more than 2 LSB apart")
    _dryrun(["cuda:0"] * 4, "[4 entry]")

    line = bench.run()
    extra = dict(line["extra"])
    if set(extra) != set(bench.EXTRA_KEYS):
        raise AssertionError(f"bench keys {tuple(extra)}, expected "
                             f"{bench.EXTRA_KEYS}")
    verbatim = extra.pop("interpreted_verbatim_1080p_fps")
    if (verbatim is None) == bench.REFERENCE_SHADERS.is_dir():
        raise AssertionError(f"interpreted section {verbatim} with "
                             f"{bench.REFERENCE_SHADERS} on disk: "
                             f"{bench.REFERENCE_SHADERS.is_dir()}")
    if verbatim is not None:
        extra["interpreted verbatim"] = verbatim
    extra["interpreted rings"] = bench.interpreted(RINGS, frames=2, builds=1)
    _numbers_ok({k: line[k] for k in ("value", "vs_baseline", "power_limit_w")}
                | extra)
    counts = _counts()
    if any(counts[k] == 0 for k in ENTRY_KERNELS):
        raise AssertionError(f"entry points launched {counts}")
    print(f"[4 entry] bench.run() ({card}): {json.dumps(line)}")
    print(f"[4 entry] launches of the entry points' run: {counts}")
    spread = bench.windows_spread()
    print(f"[4 entry] windows section, windows/s over 5 readings a window "
          f"(host clock; {card}): {json.dumps(spread)}")


# -- the compiled step: the native modules' steps as CUDA graphs ---------

COMPILED_FRAMES = 24     # replays a case checks against the eager step
# the kernel a launch counter counts, by name in a profile
KERNEL_NAMES = {"fused_update": "fused_update_kernel",
                "fused_update split": "split_stage_kernel",
                "table_lookup": "table_lookup_kernel",
                "bars_raster": "bars_raster_kernel",
                "rowwise_lookup C=1": "rowwise_",
                "rowwise_lookup C=4": "rowwise_",
                "latch_scan C=0": "latch_scan_kernel",
                "latch_scan C=4": "latch_scan_kernel",
                "smooth_scan": "smooth_scan_kernel",
                "graph_while": "while_set_kernel"}
SPLIT_N = 131072         # the split route's first bufsize
CHAIN_N = 1 << 25        # above the split plans: the chain route
# the shader modules the compiled phase runs at 1920x1080 too
SHADER_1080 = ("rings", "colfetch")


@contextlib.contextmanager
def sync_errors():
    """Inside, any torch operation that synchronises the host with the
    card raises (``torch.cuda.set_sync_debug_mode("error")``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _graph_steps(step) -> list:
    """The ``compiled.Step`` objects behind a compiled callable (one a
    shard for a sharded step)."""
    return [s.step for s in getattr(step, "steps", [step])]


def _same(got, want) -> bool:
    from glava_tpu_torch import compiled

    a, b = compiled.leaves(got), compiled.leaves(want)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _replays(label: str, step, eager, init, inputs, capture_at) -> dict:
    """``COMPILED_FRAMES`` replays of the compiled ``step`` (plus its
    captures, at the frames ``capture_at``: each branch's first call and
    a pipe write) against the ``eager`` step from the same fresh state
    (``init()``) on the same inputs (``inputs(k)``, the arguments after
    the state); every replay under ``sync_errors`` and byte-equal to the
    eager step's output, each capture where the case puts it. -> the
    launches the replays added (the counts read just before and just
    after each)."""
    frames = COMPILED_FRAMES + len(capture_at)
    graphs = _graph_steps(step)
    before = sum(g.captures for g in graphs)
    replayed = dict.fromkeys(COUNTED, 0)
    cs, es = init(), init()
    for k in range(frames):
        args = inputs(k)
        c0 = _counts()
        with contextlib.nullcontext() if k in capture_at else sync_errors():
            cs, got = step(cs, *args)
        if k not in capture_at:
            for name, n in _counts().items():
                if name in replayed:
                    replayed[name] += n - c0[name]
        es, want = eager(es, *args)
        if not _same(got, want):
            raise AssertionError(f"{label}: frame {k} of the compiled step "
                                 "differs from the eager step's")
    captured = sum(g.captures for g in graphs) - before
    if captured != len(capture_at) * len(graphs):
        raise AssertionError(f"{label}: {captured} captures, expected "
                             f"{len(capture_at) * len(graphs)}")
    return replayed


def _graph_kernels(call, frames: int = 3) -> set:
    """The names of the kernels the card ran in ``frames`` calls of
    ``call`` (replays), from torch.profiler's device rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            call()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def _check_profile(label: str, call, replayed: dict) -> str:
    """The kernels the replays launched (``replayed``) must show in a
    profile of ``call``'s replays."""
    names = _graph_kernels(call)
    want = [KERNEL_NAMES[k] for k, n in replayed.items()
            if n and k in KERNEL_NAMES]
    missing = [w for w in want if not any(w in n for n in names)]
    if missing:
        raise AssertionError(f"{label}: a profile of the replays shows no "
                             f"{missing}; it shows {sorted(names)}")
    return ", ".join(want) or "no kernel of the path"


def _render_case(label: str, module: str, screen=None, reqs=(),
                 user_dir=None, wire: str = "rgba8", profile: bool = False):
    """``Renderer.jit_step`` of ``module`` against ``step_u8`` (or
    ``step_yuv420``) over a schedule of tones, ``modified`` false every
    third frame, ``time``, ``interp_mod`` and ``gravity_g`` changing."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    lc = loader.load(cli_requests=reqs, force_module=module, user_dir=user_dir)
    r = Renderer(lc, screen=screen, device="cuda")
    yuv = wire == "yuv420"
    step = r.jit_step(quantize=not yuv, yuv420=yuv)
    eager = r.step_yuv420 if yuv else r.step_u8
    cfg = r.cfg
    snaps = [tone_snapshot(cfg, k) for k in range(COMPILED_FRAMES + 2)]
    g0 = cfg.gravity_step / cfg.nominal_ups

    def inputs(k):
        # a pipe write every frame: a step input, no new capture
        return (snaps[k], k % 3 != 2, 0.05 * k, 0.5 if k % 2 else 1.0,
                float(np.float32(g0 * (1.0 + 0.1 * (k % 4)))),
                {"fg": np.float32([0.2 + 0.03 * k, 0.9 - 0.02 * k, 0.4, 1.0])})

    replayed = _replays(label, step, eager, r.init_state, inputs, {0, 2})
    updates = sum(k % 3 != 2 for k in range(COMPILED_FRAMES + 2)
                  if k not in (0, 2))
    split = r.pipeline.route == "kernel" and r.pipeline.sz > 65536
    want = {k: COMPILED_FRAMES * LAUNCHES[module].get(k, 0) for k in COUNTED}
    fft = r.pipeline.route == "kernel"
    want["fused_update"] = updates if fft and not split else 0
    want["fused_update split"] = updates if split else 0
    _data_launches(module, replayed, want)
    if replayed != want:
        raise AssertionError(f"{label}: the replays launched {replayed}, "
                             f"expected {want}")
    shown = ""
    if profile:
        st = step.step.state
        shown = "; a profile of 3 replays shows " + _check_profile(
            label, lambda: step(st, *inputs(0)), replayed)
    w, h = r.screen
    return (f"{label} {module} {w}x{h} {wire}"
            f"{' ' + ', '.join(reqs) if reqs else ''} (update route "
            f"{r.pipeline.route}{', split' if split else ''}): "
            f"{COMPILED_FRAMES} replays byte-equal to the eager step, no host "
            f"sync inside a replay, a pipe write every frame, 2 graphs "
            f"(modified, carried), replay launches "
            f"{ {k: v for k, v in replayed.items() if v} }{shown}")


def _update_case(n: int, streams: int = 1) -> str:
    """``AudioPipeline.jit_update`` at bufsize ``n`` (smooth pass off)
    against the eager update, four seeded snapshots in turn."""
    from dataclasses import replace

    from glava_tpu_torch.config import loader
    from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec

    cfg = replace(loader.load().cfg, bufsize=n, smooth_pass=False)
    chain = ("window", "fft", "gravity", "avg")
    pipe = AudioPipeline(cfg, [UniformSpec("audio_l", "audio_l", chain),
                               UniformSpec("audio_r", "audio_r", chain)],
                         device="cuda")
    rng = np.random.default_rng(8)
    pool = [(rng.random((2, streams, n), np.float32) - 0.5) for _ in range(4)]
    g = np.float32(cfg.gravity_step / cfg.nominal_ups)
    step = pipe.jit_update()

    def eager(st, al, ar, *params):
        return pipe.update(st, torch.from_numpy(al).cuda(),
                           torch.from_numpy(ar).cuda(), gravity_g=g)

    def inputs(k):
        return (*pool[k % 4], None, None, g)

    replayed = _replays(f"update n {n}", step, eager,
                        lambda: pipe.init_state((streams,)), inputs, {0})
    return (f"AudioPipeline.jit_update n {n} S {streams} (route "
            f"{pipe.route}): {COMPILED_FRAMES} replays' textures byte-equal "
            f"to the eager update's, no host sync inside a replay, replay "
            f"launches { {k: v for k, v in replayed.items() if v} }")


def _fleet_inputs(n: int, cfg, pipe: bool = True):
    """Seeded per-frame fleet inputs: four snapshot sets in turn,
    staggered clocks (stream s updates every (1 + s % 3)-th frame),
    per-stream time and gravity, fg/bg rows written anew every frame."""
    rng = np.random.default_rng(n)
    pool = [(rng.standard_normal((n, 2, cfg.bufsize)) * 0.3).astype(np.float32)
            for _ in range(4)]
    rows = {"fg": rng.uniform(0.3, 1.0, (n, 4)).astype(np.float32),
            "bg": rng.uniform(0.0, 0.5, (n, 4)).astype(np.float32)}
    g0 = cfg.gravity_step / cfg.nominal_ups

    def inputs(k):
        mods = np.array([k % (1 + s % 3) == 0 for s in range(n)])
        write = {"fg": np.roll(rows["fg"], k, axis=0) * (1.0 - 0.01 * k),
                 "bg": rows["bg"]}
        return (pool[k % 4], mods, np.full(n, 0.05 * k, np.float32),
                np.full(n, 0.5, np.float32),
                (g0 * (1.0 + 0.1 * (np.arange(n) % 4))).astype(np.float32),
                write if pipe else None)

    return inputs


def _fleet_case(kind: str, n: int, screen=None) -> str:
    """``jit_step`` of a (mixed) batched renderer against its eager step,
    a pipe write every frame and one capture."""
    from glava_tpu_torch.parallel.batch import (
        BatchedRenderer, MixedBatchedRenderer,
    )

    loads = _kind_loads(kind)
    if len(loads) == 1:
        br = BatchedRenderer(loads[0], n, screen=screen, device="cuda")
    else:
        br = MixedBatchedRenderer(loads, [i % len(loads) for i in range(n)],
                                  screen=screen, device="cuda")
    step = br.jit_step(quantize=True)
    replayed = _replays(f"{kind} fleet S {n}", step,
                        lambda st, *a: br.step(st, *a, quantize=True),
                        br.init_state, _fleet_inputs(n, br.cfg), {0})
    want = {k: v for k, v in _fleet_want(kind, n, COMPILED_FRAMES).items()}
    if replayed != want:
        raise AssertionError(f"{kind} fleet S {n}: the replays launched "
                             f"{replayed}, expected {want}")
    st = step.step.state
    inputs = _fleet_inputs(n, br.cfg)
    shown = _check_profile(f"{kind} fleet S {n}",
                           lambda: step(st, *inputs(1)), replayed)
    w, h = br.screen
    return (f"{kind} fleet S {n} ({', '.join(FLEET_KINDS[kind])}) {w}x{h}: "
            f"{COMPILED_FRAMES} replays byte-equal to the eager fleet step "
            f"(staggered clocks, a pipe write every frame, one capture), no "
            f"host sync inside a replay, replay launches "
            f"{ {k: v for k, v in replayed.items() if v} }; a profile of 3 "
            f"replays shows {shown}")


def _sharded_case(label: str, devices, kw: dict, n: int = 16) -> str:
    """The sharded bars fleet's ``jit_step`` (one graph a device block)
    against its eager step over the mesh."""
    from glava_tpu_torch.parallel.batch import ShardedRenderer
    from glava_tpu_torch.parallel.mesh import make_mesh

    sr = ShardedRenderer(_kind_loads("bars"), [0] * n,
                         make_mesh(devices, **kw))
    step = sr.jit_step(quantize=True)
    replayed = _replays(f"bars fleet S {n} over {label}", step,
                        lambda st, *a: sr.step(st, *a, quantize=True),
                        sr.init_state, _fleet_inputs(n, sr.cfg), {0})
    want = {k: v * len(sr.shards)
            for k, v in _fleet_want("bars", 1, COMPILED_FRAMES).items()}
    if replayed != want:
        raise AssertionError(f"bars fleet S {n} over {label}: the replays "
                             f"launched {replayed}, expected {want}")
    return (f"bars fleet S {n} sharded over {label} (blocks {sr.blocks}): "
            f"{COMPILED_FRAMES} replays of one graph a device block (a pipe "
            f"write every frame, one capture a block), byte-equal to the "
            f"eager sharded step, no host sync inside a replay, replay "
            f"launches "
            f"{ {k: v for k, v in replayed.items() if v} }")


def _write_wav(path: Path, seconds: float = 0.5, rate: int = 22050) -> None:
    import wave

    t = np.arange(int(seconds * rate)) / rate
    left = 0.4 * np.sin(2 * np.pi * 300.0 * t) * (t < 0.3)
    right = 0.4 * np.sin(2 * np.pi * 2500.0 * t)
    pcm = (np.stack([left, right], axis=1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _render_wav_case(tmp: Path) -> str:
    """``render_wav`` (its compiled step, every call after both branches
    are captured under ``sync_errors``) against the same schedule
    through the eager ``step_u8``: every frame byte-equal."""
    from glava_tpu_torch import renderer as renderer_mod
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.pipeline import frame_windows
    from glava_tpu_torch.runtime import offline
    from glava_tpu_torch.runtime.audio.wav import read_wav
    from glava_tpu_torch.runtime.sinks import CallbackSink

    wav = tmp / "compiled.wav"
    _write_wav(wav)
    lc = loader.load()
    steps = []
    jit_step = renderer_mod.Renderer.jit_step

    def watched(self, *a, **kw):
        step = jit_step(self, *a, **kw)
        steps.append(step)

        def call(*args):
            guard = (sync_errors() if step.step.captures >= 2
                     else contextlib.nullcontext())
            with guard:
                return step(*args)
        return call

    got = []
    renderer_mod.Renderer.jit_step = watched
    try:
        _zero_counts()
        n = offline.render_wav(lc, str(wav), CallbackSink(
            lambda f, t: got.append(f)), fps=60.0, device="cuda")
        counts = _counts()
    finally:
        renderer_mod.Renderer.jit_step = jit_step
    cfg = lc.cfg
    left, right, rate = read_wav(str(wav))
    hop = max(cfg.samplesize // 4, 1)
    wl, wr = (frame_windows(x, cfg.bufsize, hop) for x in (left, right))
    sched = offline._schedule(len(left), rate, hop, 60.0, cfg.timecycle)
    g = float(np.float32(cfg.gravity_step / sched["ups"]))
    r = renderer_mod.Renderer(lc, device="cuda")
    st = r.init_state()
    for k in range(sched["n_frames"]):
        i = sched["widx"][k]
        st, want = r.step_u8(st, np.stack([wl[i], wr[i]]),
                             bool(sched["modified"][k]),
                             float(sched["time"][k]),
                             float(sched["interp"][k]), g)
        if not np.array_equal(got[k], want.cpu().numpy()):
            raise AssertionError(f"render_wav: frame {k} differs from the "
                                 "eager step's")
    updates = int(sched["modified"].sum())
    if not n == len(got) == sched["n_frames"] or steps[0].step.captures != 2 \
            or counts["fused_update"] != updates \
            or counts["bars_raster"] != n:
        raise AssertionError(f"render_wav: {n} frames, {len(got)} handed out, "
                             f"{steps[0].step.captures} captures, launches "
                             f"{counts} for {updates} updates")
    return (f"render_wav: {n} frames of a 0.5 s WAV through the compiled "
            f"step ({steps[0].step.captures} graphs), {n - 2} replays under "
            f"sync_errors, every frame byte-equal to the eager step_u8's; "
            f"launches { {k: v for k, v in counts.items() if v} } "
            f"({updates} updates)")


def _entry_case() -> str:
    """``entry()``'s fn (the compiled step) against ``Renderer.step`` of
    the same configuration: float32 frames byte-equal over the replays."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.entry_points import BARS_512, entry
    from glava_tpu_torch.renderer import Renderer

    fn, args = entry()
    r = Renderer(loader.load(cli_requests=BARS_512, force_module="bars"),
                 device="cuda")
    rng = np.random.default_rng(3)
    feeds = [(rng.standard_normal(tuple(args[1].shape)) * 0.2)
             .astype(np.float32) for _ in range(COMPILED_FRAMES + 1)]
    cs, es = r.init_state(), r.init_state()
    for k in range(COMPILED_FRAMES + 1):
        with contextlib.nullcontext() if k == 0 else sync_errors():
            cs, got = fn(cs, feeds[k], True, *args[3:])
        es, want = r.step(es, feeds[k], True, *args[3:])
        if not torch.equal(got, want):
            raise AssertionError(f"entry(): frame {k} differs from "
                                 "Renderer.step's")
    return (f"entry(): bars 512x256, {COMPILED_FRAMES} replays of its "
            f"compiled step byte-equal (float32) to Renderer.step, no host "
            f"sync inside a replay")


def _fuel_case(tmp: Path, frames: int = 4) -> str:
    """The fuel counter on the card: an Engine on ``cuda`` (the current
    card, no index) runs ``FUEL_FRAG`` at a fuel cap of ``FUEL_CAP``
    through its compiled step, which counts the truncated pixels on the
    device; the Engine reports them (at most once a second, and at the
    end of the run), every one; under GLAVA_TPU_WHILE_FUEL_STRICT=1 the
    run raises."""
    from glava_tpu_torch.config import glsl_shader
    from glava_tpu_torch.renderer import CompiledStep
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    root = tmp / "fuel"
    (root / "fuelloop").mkdir(parents=True, exist_ok=True)
    (root / "fuelloop" / "1.frag").write_text(FUEL_FRAG)
    w, h = 320, 240

    def engine():
        return Engine(EngineOptions(audio_backend="synth", screen=(w, h),
                                    force_module="fuelloop",
                                    user_dir=str(root), device="cuda",
                                    requests=("setprintframes false",)),
                      sink=NullSink())

    saved = {k: os.environ.get(k) for k in (
        "GLAVA_TPU_WHILE_FUEL", "GLAVA_TPU_WHILE_FUEL_STRICT",
        "GLAVA_TPU_WHILE_FUEL_WARN")}
    report = glsl_shader._fuel_report
    reports = []
    try:
        os.environ["GLAVA_TPU_WHILE_FUEL"] = str(FUEL_CAP)
        os.environ.pop("GLAVA_TPU_WHILE_FUEL_STRICT", None)
        os.environ.pop("GLAVA_TPU_WHILE_FUEL_WARN", None)
        glsl_shader.fuel_check(force=True)
        glsl_shader._fuel_report = lambda n, cap: reports.append((n, cap))
        eng = engine()
        if not isinstance(eng._step, CompiledStep):
            raise AssertionError(f"fuel: the Engine's step is {eng._step!r}")
        eng.run(max_frames=frames)
        got = sum(n for n, _ in reports)
        want = frames * h * (w - FUEL_CAP)
        if got != want or {c for _, c in reports} != {FUEL_CAP}:
            raise AssertionError(f"fuel: the Engine on {eng.renderer.device} "
                                 f"reported {reports}, expected {want} "
                                 f"pixels at cap {FUEL_CAP}")
        glsl_shader._fuel_report = report
        os.environ["GLAVA_TPU_WHILE_FUEL_STRICT"] = "1"
        try:
            engine().run(max_frames=2)
        except RuntimeError as e:
            if "fuel cap" not in str(e):
                raise
        else:
            raise AssertionError("fuel: GLAVA_TPU_WHILE_FUEL_STRICT=1 did "
                                 "not raise")
    finally:
        glsl_shader._fuel_report = report
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return (f"fuel: Engine on {eng.renderer.device}, {frames} frames of "
            f"{w}x{h} at cap {FUEL_CAP}: {got} truncated pixels reported "
            f"in {len(reports)} read(s) (expected {want}); STRICT raised")


def phase_compiled(user_dir: str, tmp: Path) -> list:
    """The compiled steps on the card: every case's replays byte-equal
    to the eager steps on the same inputs, under ``sync_errors``, with
    their launch counts and a profile of the replays, native and GLSL
    shader modules, then user Python modules (``_user_module_cases``).
    Returns the result lines."""
    lines = [_update_case(CHAIN_N)]
    for module in MODULES:
        for wire in ("rgba8", "yuv420"):
            lines.append(_render_case("single stream", module, wire=wire,
                                      profile=wire == "rgba8"))
    for wire in ("rgba8", "yuv420"):
        lines.append(_render_case("single stream", "circle", (1920, 1080),
                                  wire=wire, profile=wire == "rgba8"))
    with tempfile.TemporaryDirectory() as td:
        ud = Path(td)
        (ud / "smooth_parameters.glsl").write_text(NO_SMOOTH_PASS)
        lines.append(_render_case("split route (programmatic dependent "
                                  "launch)", "bars",
                                  reqs=(f"setbufsize {SPLIT_N}",),
                                  user_dir=str(ud), profile=True))
    lines.append(_update_case(SPLIT_N, 2))
    lines.append(_render_case("CPU path", "bars", reqs=CPU_PATH_RUNS[0]))
    for kind, n, screen in (("bars", 64, None), ("circle", 64, None),
                            ("mixed", 24, None)):
        lines.append(_fleet_case(kind, n, screen))
    for label, devices, kw in (("[cuda:0, cuda:0]", ["cuda:0"] * 2, {}),
                               ("[cuda:0] x 2 rows 2", ["cuda:0"] * 2,
                                {"rows": 2})):
        lines.append(_sharded_case(label, devices, kw))
    lines.append(_render_wav_case(tmp))
    lines.append(_entry_case())
    # GLSL shader modules: the interpreter's compiled step (a
    # data-dependent loop a while node), every kernel of its routes in
    # the graphs' profile
    for module in SHADER_MODULES:
        lines.append(_render_case("shader", module, user_dir=user_dir,
                                  profile=True))
    for module in SHADER_1080:
        lines.append(_render_case("shader", module, (1920, 1080),
                                  user_dir=user_dir, profile=True))
    lines.append(_fuel_case(tmp))
    lines += _user_module_cases(tmp)
    return lines


# user modules whose pass the compiled step refuses: two read a tensor
# on the host (refused in the warm-up), one synchronises the card (runs
# eagerly, then fails inside the capture)
USER_MODULE = """
import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register("{name}", uniforms=(("audio_l", "audio_l",
                               ("window", "fft", "gravity", "avg")),))
def build(ctx):
    w, h = ctx.screen
    ramp = torch.linspace(0.0, 1.0, w, device=ctx.device)

    def pass1(inputs):
        level = torch.mean(inputs.textures["audio_l"])
        {line}
        a = (ramp < level).to(torch.float32).expand(h, w)
        return (a, a * 0.5, a * 0.25, a)

    return base.ModuleBuild("{name}", [pass1])
"""
# user modules whose pass reads the per-frame time and, with a stream
# axis (`timedb`), each stream's fg pipe row: a value frozen at the
# capture would part the replays from the eager step
USER_TIMED = """
import torch

from glava_tpu_torch.render import base
from glava_tpu_torch.render.modules import register


@register("{name}", uniforms=(("audio_l", "audio_l",
                               ("window", "fft", "gravity", "avg")),))
def build(ctx):
    w, h = ctx.screen
    ramp = torch.linspace(0.0, 1.0, w, device=ctx.device)

    def pass1(inputs):
        level = torch.mean(inputs.textures["audio_l"], dim=-1, keepdim=True)
        t = base.f32_tensor(inputs.time, ramp.device).reshape(-1, 1)
        wave = 0.5 + 0.5 * torch.sin(ramp * 6.0 + 3.0 * t)
        gain = (base.f32_tensor(inputs.pipe["fg"], ramp.device)[:, :1]
                if inputs.pipe else torch.ones_like(t))
        planes = ((ramp < level * 40.0).to(torch.float32) * wave, wave,
                  wave * gain, torch.ones_like(wave))
        if {batched}:
            return tuple(p[:, None, :].expand(-1, h, w) for p in planes)
        return tuple(p.expand(h, w) for p in planes)

    return base.ModuleBuild("{name}", [pass1], batched={batched})
"""
USER_REFUSED = {
    "hostread": ("level = level + level.item()",
                 "its pass reads a tensor on the host (Tensor.item)"),
    "devsync": ("torch.cuda.synchronize()",
                "its pass failed inside the capture"),
    "hostcopy": ("level = level + level.to('cpu').sum()",
                 "its pass reads a tensor on the host (Tensor.to)"),
}


def _vu_root(d: Path) -> str:
    """A config root at ``d`` whose ``modules/`` holds vu_meter."""
    (d / "modules").mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "glava_tpu_torch" / "examples" / "vu_meter.py",
                d / "modules" / "vu_meter.py")
    return str(d)


def _user_module_cases(tmp: Path) -> list:
    """vu_meter (``glava_tpu_torch/examples/vu_meter.py``, a user Python
    module) through its compiled step: one stream (``_render_case``), a
    fleet of 8, a mixed fleet of 8 (bars and vu_meter) and the fleet of
    8 sharded over ``[cuda:0, cuda:0]`` on rows 2; the ``USER_TIMED``
    modules (the time, a pipe row) one stream and a fleet of 8; each
    ``COMPILED_FRAMES`` replays byte-equal to the eager step under
    ``sync_errors``, one capture a branch (a device block); then each
    ``USER_REFUSED`` module refused by name (``compiled.Uncapturable``),
    after which no stream is left capturing and bars' compiled step
    captures and replays byte-equal to its eager step."""
    from glava_tpu_torch import compiled
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.parallel.batch import (
        BatchedRenderer, MixedBatchedRenderer, ShardedRenderer,
    )
    from glava_tpu_torch.parallel.mesh import make_mesh
    from glava_tpu_torch.renderer import Renderer

    root = Path(_vu_root(tmp / "user"))
    for name, (line, _) in USER_REFUSED.items():
        (root / "modules" / f"{name}.py").write_text(
            USER_MODULE.format(name=name, line=line))
    timed = ("timed", "timedb")
    for name in timed:
        (root / "modules" / f"{name}.py").write_text(
            USER_TIMED.format(name=name, batched=name == "timedb"))
    lines = [_render_case("user module", "vu_meter", user_dir=str(root),
                          profile=True)]
    lines += [_render_case("user module reading the time and a pipe row",
                           name, user_dir=str(root)) for name in timed]
    vu = loader.load(force_module="vu_meter", user_dir=str(root))
    bars = loader.load(force_module="bars")
    n = 8
    for label, br, mods, blocks in (*(
            (f"{name} fleet", BatchedRenderer(loader.load(
                force_module=name, user_dir=str(root)), n, device="cuda"),
             [name] * n, 1) for name in timed),
            ("vu_meter fleet", BatchedRenderer(vu, n, device="cuda"),
             ["vu_meter"] * n, 1),
            ("mixed bars/vu_meter fleet", MixedBatchedRenderer(
                [bars, vu], [i % 2 for i in range(n)], device="cuda"),
             [("bars", "vu_meter")[i % 2] for i in range(n)], 1),
            ("vu_meter fleet sharded over [cuda:0] x 2 rows 2",
             ShardedRenderer([vu], [0] * n, make_mesh(["cuda:0"] * 2,
                                                      rows=2)),
             ["vu_meter"] * n, 2)):
        step = br.jit_step(quantize=True)
        replayed = _replays(f"{label} S {n}", step,
                            lambda st, *a, br=br: br.step(st, *a,
                                                          quantize=True),
                            br.init_state, _fleet_inputs(n, br.cfg), {0})
        want = {k: v * blocks
                for k, v in _block_want(mods, COMPILED_FRAMES).items()}
        if replayed != want:
            raise AssertionError(f"{label} S {n}: the replays launched "
                                 f"{replayed}, expected {want}")
        lines.append(f"user module {label} S {n}: {COMPILED_FRAMES} replays "
                     f"byte-equal to the eager fleet step (a pipe write every "
                     f"frame, one capture a device block), no host sync "
                     f"inside a replay, replay launches "
                     f"{ {k: v for k, v in replayed.items() if v} }")
    for name, (_, why) in USER_REFUSED.items():
        r = Renderer(loader.load(force_module=name, user_dir=str(root)),
                     device="cuda")
        step = r.jit_step(quantize=True)
        cfg = r.cfg
        try:
            step(r.init_state(), tone_snapshot(cfg, 0), True, 0.0, 1.0,
                 cfg.gravity_step / cfg.nominal_ups)
        except compiled.Uncapturable as e:
            if not str(e).startswith(f"module '{name}' has no compiled step: "
                                     f"{why}"):
                raise AssertionError(f"{name}: refused as {e}") from e
            refusal = str(e).splitlines()[0][:160]
        else:
            raise AssertionError(f"the user module {name} was captured")
        capturing = torch.cuda.is_current_stream_capturing()
        if step.step._capture_stream is not None:
            with torch.cuda.stream(step.step._capture_stream):
                capturing |= torch.cuda.is_current_stream_capturing()
        if capturing:
            raise AssertionError(f"{name}: a stream is left capturing")
        after = _render_case(f"after {name}'s refusal", "bars")
        lines.append(f"user module {name} refused: {refusal}; no stream "
                     f"left capturing; then {after[:after.index(':')]}: "
                     f"{COMPILED_FRAMES} replays byte-equal to the eager step")
    return lines


# -- the host runtime: the frame's way to the host, pipe values, the
# -- wallpaper, the embedding API, the FIFO backend ----------------------

# shader modules whose colour is a pipe knob, read inside the pass:
# `@fg` (--pipe fg) and `@STDIN` (--stdin, bare values)
PIPE_FRAG = BASE_FRAG.replace("vec3(0.13, 0.67, 0.4)", "BASE.rgb").replace(
    "out vec4 fragment;\n", "out vec4 fragment;\n#define BASE @fg:#22aa66\n")
STDIN_FRAG = PIPE_FRAG.replace("@fg:", "@STDIN:")
# (module, pipe binds, the pipe stream's line): each turns the drawn
# colour green
PIPE_RUNS = (("bars", ("fg", "bg"), "fg = #00ff00"),
             ("graph", ("fg", "bg"), "fg = #00ff00"),
             ("pipebar", ("fg", "bg"), "fg = #00ff00"),
             ("stdinbar", ("STDIN",), "#00ff00"))
HOST_SCREEN = (1920, 1080)
FETCH_FRAMES = 8
SMALL = ("setgeometry 0 0 320 240", "setprintframes false")


def _host_planes(frame) -> tuple:
    return frame if isinstance(frame, tuple) else (frame,)


def _stress(nbytes: int, n: int) -> None:
    """A large write to freshly allocated device memory: ``n`` buffers
    of a frame's size, each filled on the compute stream. A frame still
    being copied whose memory the allocator handed out again would be
    overwritten here."""
    bufs = [torch.empty(nbytes, dtype=torch.uint8, device="cuda")
            for _ in range(n)]
    for i, b in enumerate(bufs):
        b.fill_(0x5A + i)


def _fetch_check(module: str, sink_kind: str, depth: int,
                 compiled: bool = False) -> str:
    """One stream of device frames through the Engine's own fetch path
    (``FrameFetch``) at 1920x1080: the engine's step is wrapped to keep
    a device copy of each frame (and of the RGBA frame of the same
    planes) and to write fresh allocations between steps. Every buffer
    the sink gets must be pinned and byte-equal to a synchronous
    ``.cpu()`` of its device frame; on the yuv420 wire the planes must
    be within 1 LSB of ``yuv420_pack_host`` of the RGBA frame. With
    ``compiled`` the wrapped step is the Engine's own compiled step,
    whose frame is one static buffer each replay overwrites (the copy
    kept is taken on the compute stream right after the call)."""
    import io

    from glava_tpu_torch.render.base import interleave_u8
    from glava_tpu_torch.renderer import yuv420_buffer, yuv420_pack_host
    from glava_tpu_torch.runtime import sinks
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions

    inner = (sinks.Y4MSink(io.BytesIO()) if sink_kind == "y4m"
             else sinks.NullSink())
    got = []

    class Tee(sinks.FrameSink):
        wire_format = getattr(inner, "wire_format", "rgba8")

        def submit(self, frame, t):
            got.append((frame, all(torch.from_numpy(p).is_pinned()
                                   for p in _host_planes(frame))))
            inner.submit(frame, t)

    eng = Engine(EngineOptions(audio_backend="synth", screen=HOST_SCREEN,
                               force_module=module, inflight=depth,
                               requests=("setprintframes false",),
                               device="cuda"), sink=Tee())
    r, wire = eng.renderer, eng._wire
    w, h = r.screen
    want_wire = ("yuv420", w, h) if sink_kind == "y4m" else ("rgba8",)
    if wire != want_wire:
        raise AssertionError(f"{module} {sink_kind}: wire {wire}, expected "
                             f"{want_wire}")
    want = []
    nbytes = w * h * 3 // 2 if wire[0] == "yuv420" else w * h * 4

    def step(state, audio, modified, t, interp, g, pipe):
        _stress(nbytes, depth + 2)
        st, planes = r.step_planes(state, audio, modified, t, interp, g, pipe)
        rgba = interleave_u8(planes, h, w, r.device)
        frame = (yuv420_buffer(planes, h, w, r.device)
                 if wire[0] == "yuv420" else rgba)
        want.append((frame.clone(), rgba.clone()))
        return st, frame

    jit = eng._step

    def replayed(state, audio, modified, t, interp, g, pipe):
        _stress(nbytes, depth + 2)
        st, frame = jit(state, audio, modified, t, interp, g, pipe)
        want.append((frame.clone(), None))
        return st, frame

    eng._step = replayed if compiled else step
    _zero_counts()
    eng.run(max_frames=FETCH_FRAMES)
    torch.cuda.synchronize()
    counts = _counts()
    if eng.updates == 0 or counts["fused_update"] != eng.updates or any(
            counts[k] != FETCH_FRAMES * n for k, n in LAUNCHES[module].items()):
        raise AssertionError(f"{module} fetch path: launches {counts}, "
                             f"{eng.updates} updates")
    if len(got) != FETCH_FRAMES or not all(pinned for _, pinned in got):
        raise AssertionError(f"{module} {sink_kind} inflight {depth}: "
                             f"{len(got)} frames, pinned "
                             f"{[pinned for _, pinned in got]}")
    lsb = 0
    for (host, _), (dev, rgba) in zip(got, want):
        ref = dev.cpu().numpy()
        if b"".join(p.tobytes() for p in _host_planes(host)) != ref.tobytes():
            raise AssertionError(f"{module} {sink_kind} inflight {depth}: a "
                                 "host frame differs from .cpu() of its "
                                 "device frame")
        if wire[0] == "yuv420" and rgba is not None:
            for a, b in zip(host, yuv420_pack_host(rgba.cpu().numpy())):
                lsb = max(lsb, int(np.abs(a.astype(np.int16) - b).max()))
    if lsb > 1:
        raise AssertionError(f"{module} yuv420 planes {lsb} LSB off the host "
                             "pack")
    return (f"{module} {w}x{h} {sink_kind} ({wire[0]}) inflight {depth}"
            f"{', the compiled step' if compiled else ''}: "
            f"{FETCH_FRAMES} pinned "
            f"frames byte-equal to .cpu()"
            + (f", YUV within {lsb} LSB of yuv420_pack_host" if (
                lsb or wire[0] == "yuv420") and not compiled else ""))


def _fleet_fetch_check(n: int = 8, frames: int = 3) -> str:
    """``FleetEngine.fetch`` at 1920x1080: the host frames pinned and
    byte-equal to a synchronous ``.cpu()`` of the device frames."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.runtime.fleet import FleetEngine

    eng = FleetEngine(loader.load(), _fleet_streams(n), screen=HOST_SCREEN,
                      device="cuda")
    cfg = eng.loaded.cfg
    rng = np.random.default_rng(3)
    g = np.full(n, cfg.gravity_step / cfg.nominal_ups, np.float32)
    for _ in range(frames):
        snaps = (rng.standard_normal((n, 2, cfg.bufsize)) * 0.3).astype(np.float32)
        dev = eng.step(snaps, np.ones(n, bool), 0.0, np.ones(n, np.float32), g)
        host = eng.fetch(dev)
        if not torch.from_numpy(host).is_pinned() or \
                host.tobytes() != dev.cpu().numpy().tobytes():
            raise AssertionError("FleetEngine.fetch: a host frame is not "
                                 "pinned or differs from .cpu()")
    return (f"FleetEngine.fetch S {n} {HOST_SCREEN[0]}x{HOST_SCREEN[1]}: "
            f"{frames} pinned (S, H, W, 4) frames byte-equal to .cpu()")


def _fixed_engine(device: str, module: str, user_dir=None, reqs=SMALL,
                  sink=None, pipe_stream=None, **opts):
    """An Engine whose ring snapshots are the fixed tones of
    ``tone_snapshot`` (one hop a frame, every frame an update), so a
    cuda and a cpu run see the same audio."""
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import LatestFrameSink

    eng = Engine(EngineOptions(audio_backend="synth", force_module=module,
                               user_dir=user_dir, requests=reqs,
                               device=device, **opts),
                 sink=sink or LatestFrameSink(), pipe_stream=pipe_stream)
    cfg = eng.loaded.cfg
    k = iter(range(1 << 30))
    eng.audio.snapshot = lambda: (tone_snapshot(cfg, next(k)), True)
    return eng


def _pipe_frame(device: str, module: str, user_dir: str, binds,
                line: str) -> np.ndarray:
    """The 6th frame of an Engine whose pipe stream sends ``line`` (its
    reader has consumed it before the first frame)."""
    import io

    from glava_tpu_torch.runtime.stdin_pipe import PipeBind

    eng = _fixed_engine(device, module, user_dir,
                        pipe_stream=io.StringIO(line + "\n"),
                        pipe_binds=tuple(PipeBind(b, "vec4") for b in binds))
    eng.pipe.start()
    while not eng.pipe.eof:
        time.sleep(0.001)
    eng.run(max_frames=6)
    return eng.tex()


class _FakeLibpulse:
    """A stand-in for libpulse-simple's four entry points: each read
    fills the fragment with a 440 Hz stereo tone, paced at the sample
    rate, so the pulseaudio backend's ctypes path runs without a
    PulseAudio server."""

    def __init__(self, rate: int = 22050):
        self.rate, self.n = rate, 0

    def pa_simple_new(self, *args):
        return 1

    def pa_simple_read(self, handle, buf, nbytes, err):
        import ctypes

        frames = int(getattr(nbytes, "value", nbytes)) // 8
        t = (self.n + np.arange(frames)) / self.rate
        self.n += frames
        tone = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        ctypes.memmove(buf, np.repeat(tone, 2).tobytes(), frames * 8)
        time.sleep(frames / self.rate)
        return 0

    def pa_simple_free(self, handle):
        pass

    def pa_strerror(self, code):
        return b"stand-in"


def _wallpaper(path: Path, rgb) -> None:
    from glava_tpu_torch.runtime.sinks import write_png

    wall = np.zeros((300, 400, 4), np.uint8)
    wall[..., :3] = rgb
    wall[..., 0] = np.minimum(wall[..., 0] + np.arange(400)[None, :] // 4, 255)
    wall[..., 3] = 255
    write_png(path, wall)


def phase_host(user_dir: str, tmp: Path) -> None:
    """Phase 4's host-runtime checks on the card, each raising on a miss."""
    import os
    import threading

    from glava_tpu_torch import api
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import CallbackSink

    for module in ("bars", "circle"):
        for sink_kind in ("y4m", "null"):
            for depth in (0, 1, 2):
                print(f"[4 host] {_fetch_check(module, sink_kind, depth)}")
                print(f"[4 host] "
                      f"{_fetch_check(module, sink_kind, depth, True)}")
    print(f"[4 host] {_fleet_fetch_check()}")

    for name, frag in (("pipebar", PIPE_FRAG), ("stdinbar", STDIN_FRAG)):
        (Path(user_dir) / name).mkdir(exist_ok=True)
        (Path(user_dir) / name / "1.frag").write_text(frag)
    for module, binds, line in PIPE_RUNS:
        ud = user_dir if module.endswith("bar") else None
        gpu, cpu = (_pipe_frame(d, module, ud, binds, line)
                    for d in ("cuda", "cpu"))
        frac = golden_rule(gpu, cpu)
        drawn = gpu[gpu[..., 3] > 0]
        if frac >= 0.002 or not drawn.size or \
                drawn[:, :3].mean(axis=0).argmax() != 1:
            raise AssertionError(f"pipe '{line}', {module}: cuda vs cpu "
                                 f"{frac:.4%} off, drawn {drawn.shape}")
        print(f"[4 host] pipe '{line}' (binds {', '.join(binds)}) through "
              f"Engine, {module} 320x240: green drawn, cuda vs cpu "
              f"{frac:.4%} px > 2 LSB")

    wp = tmp / "wall.png"
    _wallpaper(wp, (200, 40, 40))
    reqs = ("setgeometry 16 12 320 240", "setprintframes false",
            'setopacity "xroot"', f'setbgimg "{wp}"')
    gpu, cpu = (_fixed_engine(d, "bars", reqs=reqs) for d in ("cuda", "cpu"))
    for eng in (gpu, cpu):
        eng.run(max_frames=6)
    frac = golden_rule(gpu.tex(), cpu.tex())
    if frac >= 0.002:
        raise AssertionError(f"setbgimg xroot bars: cuda vs cpu {frac:.4%} off")
    frames = []

    def swap(f, t):
        frames.append(f)
        if len(frames) == 3:
            _wallpaper(wp, (30, 40, 210))

    eng = _fixed_engine("cuda", "bars", reqs=reqs, sink=CallbackSink(swap))
    eng.run(max_frames=10)

    def modal(f):   # the wallpaper's blue, constant over the image
        v, n = np.unique(f[..., 2], return_counts=True)
        return int(v[n.argmax()])

    first, last = modal(frames[1]), modal(frames[-1])
    if first != 40 or last != 210:
        raise AssertionError(f"wallpaper swap: modal colours {first} -> {last}")
    print(f"[4 host] setbgimg + xroot, bars 320x240: cuda vs cpu {frac:.4%} px "
          f"> 2 LSB; a wallpaper swapped mid-run reaches the composite "
          f"(modal blue {first} -> {last})")

    h = api.entry(["--device", "cuda", "-a", "synth", "--size", "320x240",
                   "-r", "setprintframes false"])
    try:
        api.wait(h, timeout=120)
        f0 = api.tex(h)
        api.sizereq(h, 0, 0, 640, 480)
        deadline = time.monotonic() + 60
        while api.tex(h).shape != (480, 640, 4) and time.monotonic() < deadline:
            time.sleep(0.01)
        f1 = api.tex(h)
    finally:
        api.terminate(h)
    if f0.shape != (240, 320, 4) or f1.shape != (480, 640, 4) or h.alive \
            or h.error is not None or h.engine.renderer.device.type != "cuda":
        raise AssertionError(f"api: {f0.shape} -> {f1.shape}, alive {h.alive}, "
                             f"error {h.error!r}")
    print(f"[4 host] api.entry(--device cuda): wait, tex {f0.shape}, sizereq "
          f"-> tex {f1.shape}, terminate ({h.engine.frames_rendered} frames)")

    fifo = tmp / "mpd.fifo"
    os.mkfifo(fifo)

    def writer():
        t = np.arange(22050 * 3) / 22050.0
        pcm = (np.sin(2 * np.pi * 440 * t) * 20000).astype("<i2")
        inter = np.repeat(pcm, 2)
        try:
            with open(fifo, "wb") as fh:
                for i in range(0, len(inter), 1024):
                    fh.write(inter[i:i + 1024].tobytes())
                    fh.flush()
                    time.sleep(1024 / 2 / 22050.0)
        except BrokenPipeError:
            pass   # the engine stopped reading first

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    eng = Engine(EngineOptions(audio_backend="fifo", screen=(320, 240),
                               requests=("setprintframes false",
                                         f'setsource "{fifo}"'),
                               device="cuda"))
    _zero_counts()
    eng.run(max_seconds=2.0)
    torch.cuda.synchronize()
    counts = _counts()
    frame = eng.tex()
    wt.join(timeout=10)
    if eng.updates == 0 or counts["fused_update"] != eng.updates \
            or frame is None or not (frame[..., 3] > 0).any():
        raise AssertionError(f"fifo: {eng.frames_rendered} frames, "
                             f"{eng.updates} updates, launches {counts}")
    print(f"[4 host] fifo backend ({type(eng.audio).__name__}) through "
          f"os.mkfifo: {eng.frames_rendered} frames on cuda, {eng.updates} "
          f"updates, launches {counts}")

    from glava_tpu_torch.runtime.audio.pulse import PulseBackend

    PulseBackend.libpulse = _FakeLibpulse()
    try:
        eng = Engine(EngineOptions(audio_backend="pulseaudio",
                                   screen=(320, 240), device="cuda",
                                   requests=("setprintframes false",
                                             'setsource "stand-in.monitor"')))
        _zero_counts()
        eng.run(max_seconds=1.5)
        torch.cuda.synchronize()
    finally:
        PulseBackend.libpulse = None
    counts = _counts()
    frame = eng.tex()
    if eng.updates == 0 or counts["fused_update"] != eng.updates \
            or frame is None or not (frame[..., 3] > 0).any():
        raise AssertionError(f"pulseaudio: {eng.frames_rendered} frames, "
                             f"{eng.updates} updates, launches {counts}")
    print(f"[4 host] pulseaudio backend (pa_simple over a stand-in "
          f"libpulse): {eng.frames_rendered} frames on cuda, {eng.updates} "
          f"updates, launches {counts}")


def _update_sets(n: int, B: int, F: int = 6) -> list:
    """Input sets of fused_update, more of them than the 50 MB L2 holds
    together, so a rotation through them gives each call fresh inputs."""
    from glava_tpu_torch.ops import fused, windows

    m = n // 2
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    window = t(windows.pcm_window(n))
    w_age = t(fused.age_weights(windows.avg_weights(F, True, True)))
    return [(t(rng.standard_normal((B, n)) * 0.3),
             t(rng.uniform(0, 1, (B, 2, m))),
             t(rng.uniform(0, 1, (B, F, 2, m))),
             t(np.arange(B) % F, torch.int32),
             t(np.full(B, 10.2)), t(np.full(B, 0.3)), t(np.full(B, 0.05)),
             window, w_age)
            for _ in range(max(2, -(-64 * 2 ** 20 // update_bytes(n, B, F))))]


def _update_times(n: int, B: int):
    """fused_update at bufsize n and B rows: event times of the kernel
    and its plain version, each call on fresh inputs, the profiler's
    device time of the kernel on one warm input set (on the split route
    also each of its two kernels', else an empty dict) and the bytes."""
    from glava_tpu_torch.ops import fused

    sets = _update_sets(n, B)
    K = len(sets)
    kernel = event_ms(lambda i: fused.fused_update(*sets[i % K]), 200)
    plain = event_ms(lambda i: fused.fused_update_plain(*sets[i % K]), 10)
    profiled = device_ms(lambda: fused.fused_update(*sets[0]))
    each = (kernel_ms(lambda: fused.fused_update(*sets[0]), SPLIT_KERNELS, 20)
            if fused.fft_plan(n).split else {})
    return kernel, plain, profiled, each, update_bytes(n, B, 6), K


def host_us(fn, iters: int = 1000, repeats: int = 5) -> float:
    """Median host microseconds per call of ``fn(i)``: the caller's time
    to enqueue it, with the card keeping up (each call's kernel must be
    shorter than its host time for this to hold)."""
    fn(0)
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        runs.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return float(np.median(runs))


def _tree_variants(dirs: list[str], py: str = "fused.py",
                   cu: str = "fused_update.cu") -> list:
    """Other trees' wrappers and kernels, each from a directory holding
    its ``py`` (a module of ``glava_tpu_torch/ops``) and ``cu``: (name,
    module loaded under its own name, its kernel built into build/ and
    loaded), the nvcc runs side by side."""
    import ctypes
    import importlib.util

    from glava_tpu_torch.ops import _build

    mods = []
    stem = Path(cu).stem
    for d in map(Path, dirs):
        name = f"{stem}_ab_{d.name}"
        spec = importlib.util.spec_from_file_location(name, d / py)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod      # dataclasses look their module up
        spec.loader.exec_module(mod)
        mods.append((d, mod))
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(_build.BUILD_DIR / f"{stem}_ab_{d.name}.so"), str(d / cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for d, _ in mods]
    logs = [p.communicate()[0] for p in procs]
    out = []
    for (d, mod), proc, log in zip(mods, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d}:\n{log}")
        so = _build.BUILD_DIR / f"{stem}_ab_{d.name}.so"
        ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                           if "registers" in ln)
        print(f"[ab] built {d.name}: {ptxas}")
        out.append((d.name, mod, _build.Built(ctypes.CDLL(str(so)), so, 0.0,
                                              log)))
    return out


@contextlib.contextmanager
def _serving(built, name: str = "fused_update"):
    """Let ``_build.load(name)``, through which a variant's wrapper
    finds its kernel, return ``built`` for a while."""
    from glava_tpu_torch.ops import _build

    saved = _build._LOADED.get(name)
    _build._LOADED[name] = built
    try:
        yield
    finally:
        if saved is None:
            del _build._LOADED[name]
        else:
            _build._LOADED[name] = saved


# (n, B) of the split route's shapes in ``--fused-ab``
SPLIT_AB = ((131072, 2), (262144, 2), (524288, 2), (131072, 128),
            (262144, 128))
SPLIT_KERNELS = ("split_columns_kernel", "split_stage_kernel")


def fused_ab(dirs: list[str]) -> int:
    """``--fused-ab DIR ...``: the fused update of each DIR (a tree's
    ``glava_tpu_torch/ops/fused.py`` and ``csrc/fused_update.cu``, for
    example from ``git show <commit>:<path>``) beside this checkout's,
    in one process on one card. At n in {512, ..., 16384} (k = 1, 2, 4,
    8 and 8 with 1024-point CTA FFTs) and B in {2, 128}, and on the
    split route at ``SPLIT_AB``: CUDA-event time on fresh inputs and the
    profiler's warm time (on the split route also each of its two
    kernels' own), each variant twice, in the order given and then
    reversed. Every variant's first call is held against the plain
    version (``_tolerance``) and must count one launch (on the split
    route one split launch), so a mix-up of kernels fails the run. Then
    the host time of one call at n 4096, B 2 (``_host_ab``)."""
    from glava_tpu_torch.ops import _build, fused

    card = phase_device()
    variants = [("this", fused, _build.load("fused_update")),
                *_tree_variants(dirs)]
    shapes = tuple((n, B) for n in (512, 1024, 2048, 4096, 16384)
                   for B in (2, 128)) + SPLIT_AB
    for n, B in shapes:
        split = fused.fft_plan(n).split
        sets = _update_sets(n, B)
        K = len(sets)
        order = variants + variants[::-1]
        for r, (name, mod, built) in enumerate(order):
            # the timed calls update the sets' state in place
            pg, _, pavg = fused.fused_update_plain(*sets[0])
            tol = _tolerance(sets[0], pg, pavg)
            with _serving(built):
                count = "split_launches" if split else "launches"
                before = getattr(mod, count)
                args = [a.clone() for a in sets[0][:3]] + list(sets[0][3:])
                kg, _, kavg = mod.fused_update(*args)
                err = max((kg - pg).abs().max().item(),
                          (kavg - pavg).abs().max().item())
                if getattr(mod, count) != before + 1 or not err <= tol:
                    raise AssertionError(f"{name} n{n} B{B}: {count} "
                                         f"{getattr(mod, count) - before}, "
                                         f"err {err} (tolerance {tol})")
                ev = event_ms(lambda i: mod.fused_update(*sets[i % K]),
                              50 if B * n > 2 ** 22 else 200)
                warm = device_ms(lambda: mod.fused_update(*sets[0]))
                parts = ""
                if split:
                    each = kernel_ms(lambda: mod.fused_update(*sets[0]),
                                     SPLIT_KERNELS)
                    parts = ", " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                             for k, v in each.items())
            print(f"[ab] fused n{n} B{B} {name}: events {ev * 1e3:.2f} us, "
                  f"warm {warm * 1e3:.2f} us{parts}, err {err:.2e} "
                  f"(tolerance {tol:.2e}), round {r // len(variants)} "
                  f"({card})")
        print(f"[ab] fused n{n} B{B}: bound "
              f"{bound_ms(update_bytes(n, B, 6)) * 1e3:.3f} us (bytes), "
              f"{K} input sets in turn")
    _host_ab(variants, card)
    return 0


def smooth_ab(dirs: list[str]) -> int:
    """``--smooth-ab DIR ...``: the smooth transform of each DIR (a
    tree's ``glava_tpu_torch/ops/smooth.py`` and ``csrc/smooth_scan.cu``)
    beside this checkout's, in one process on one card, at the main
    path's shape (1 row, sz 4096, ratio 4, d 0.01) and the other
    ``SMOOTH_CASES``: CUDA-event time on 8 live rows
    (``smooth_live_rows``, every output bin checked nonzero) in turn, each
    variant twice, in the order given and then reversed. Every
    variant's first call is held against the plain version (zeros
    equal, ``SMOOTH_TOL``), so a mix-up of kernels fails the run."""
    from glava_tpu_torch.ops import _build, smooth

    card = phase_device()
    variants = [("this", smooth, _build.load("smooth_scan")),
                *_tree_variants(dirs, "smooth.py", "smooth_scan.cu")]
    for sz, ratio, d in ((4096, 4.0, 0.01),) + tuple(
            c for c in SMOOTH_CASES if c != (4096, 4.0, 0.01)):
        sets = [torch.as_tensor(x, device="cuda")
                for x in smooth_live_rows(sz, 8)]
        want = smooth.smooth_transform_plain(sets[0], ratio, d)
        asz = -(-sz // int(ratio))
        for r, (name, mod, built) in enumerate(variants + variants[::-1]):
            with _serving(built, "smooth_scan"):
                mod._FN = None          # resolve the served kernel
                before = mod.launches
                got = mod.smooth_transform(sets[0], ratio, d)
                err = (got - want).abs().max().item()
                if mod.launches != before + 1 or not err <= SMOOTH_TOL \
                        or not torch.equal(got == 0, want == 0):
                    raise AssertionError(f"{name} smooth sz {sz} ratio "
                                         f"{ratio} d {d}: err {err}")
                for i, x in enumerate(sets):
                    _check_live(mod.smooth_transform(x, ratio, d), asz,
                                f"{name} sz {sz} ratio {ratio} d {d} set {i}")
                ms = event_ms(lambda i: mod.smooth_transform(
                    sets[i % 8], ratio, d), 20 if sz > 4096 else 100)
                mod._FN = None
            print(f"[ab] smooth_scan 1 row sz {sz} ratio {ratio:g} d {d:g} "
                  f"{name}: events {ms * 1e3:.2f} us, {ms * 1e6 / asz:.1f} ns "
                  f"a bin, err {err:.2e}, round {r // len(variants)} ({card})")
    return 0


def while_ab(dirs: list[str]) -> int:
    """``--while-ab DIR ...``: the while setter of each DIR (a tree's
    ``glava_tpu_torch/ops/graph_while.py`` and ``csrc/graph_while.cu``
    whose ``glava_while_set`` takes this checkout's arguments, served to
    this checkout's wrapper) beside this checkout's, in one process on
    one card, in the order given and then reversed: each variant equal to the plain
    version (``_setter_err``) and through the while node check, then its
    CUDA-event time on fresh 1920x1080 planes, its profiler time inside
    replays of a captured loop (``_setter_in_replay``) and, in the
    audioloop shader module's 800x600 frame, eager and captured, its
    launches, device us a launch and a frame (``_setter_profile``). A
    variant that fails prints why and the next one runs."""
    from glava_tpu_torch.ops import _build, graph_while

    card = phase_device()
    phase_build()
    this = _build.load("graph_while")
    variants = [("this", this),
                *((name, built) for name, _, built in _tree_variants(
                    dirs, "graph_while.py", "graph_while.cu"))]
    with tempfile.TemporaryDirectory() as td:
        ud = str(write_shader_modules(Path(td)))
        for r, (name, built) in enumerate(variants + variants[::-1]):
            with _serving(built, "graph_while"):
                graph_while._FNS.clear()
                try:
                    err = _setter_err()
                    node = _while_node_check()
                    ev = _while_times()["ms"] * 1e3
                    n, us = _setter_in_replay()
                    loop = []
                    for captured in (False, True):
                        _, _, frame = _frame_ms(None, "audioloop", ud, 5,
                                                compiled=captured)
                        ln, lus = _setter_profile(frame, 10)
                        loop.append(f"{'captured' if captured else 'eager'} "
                                    f"{ln:.1f} launches, {lus:.2f} us a "
                                    f"launch, {ln * lus:.2f} us a frame")
                    print(f"[ab] graph_while {name}: err {err}, node {node}; "
                          f"1920x1080 events {ev:.2f} us, in a "
                          f"{WHILE_TRIPS}-trip replay {us:.2f} us a launch "
                          f"({n:.0f} a replay); audioloop 800x600 "
                          f"{'; '.join(loop)}; round {r // len(variants)} "
                          f"({card})", flush=True)
                except (RuntimeError, AssertionError) as e:
                    print(f"[ab] graph_while {name}: failed: {e}", flush=True)
                finally:
                    graph_while._FNS.clear()
    return 0


def _host_ab(variants: list, card: str, rounds: int = 8) -> None:
    """Host microseconds of one fused_update call at n 4096, B 2 (the
    kernel, ~7 us, is shorter than the call, so the card keeps up), the
    variants alternated over ``rounds``: through each wrapper, and, for
    variants with this checkout's C interface, of the C entry alone
    (ctypes, argument checks, tensor maps, the launch). Prints each
    variant's least and median round."""
    from glava_tpu_torch.ops import fused

    n, B, F = 4096, 2, 6
    sets = _update_sets(n, B, F)
    K = len(sets)
    tw = fused._twiddles(fused.fft_plan(n), sets[0][0].device)
    stream = torch.cuda.current_stream().cuda_stream
    argsets = []
    for pcm, grav, hist, slot, fs, fc, g, win, w in sets:
        avg = torch.empty_like(grav)
        argsets.append((avg, tuple(t.data_ptr() for t in (
            pcm, win, tw, w, slot, fs, fc, g, grav, hist, avg))
            + (B, n, F, *fused._plan_args(n, F), stream)))
    runs: dict[str, list[float]] = {}
    for r in range(rounds):
        for name, mod, built in (variants if r % 2 == 0 else variants[::-1]):
            with _serving(built):
                runs.setdefault(f"{name} wrapper", []).append(
                    host_us(lambda i: mod.fused_update(*sets[i % K]), 300, 3))
                if hasattr(mod, "_kernel"):
                    fn = mod._kernel()
                    runs.setdefault(f"{name} C entry", []).append(
                        host_us(lambda i: fn(*argsets[i % K][1]), 300, 3))
    for label, us in runs.items():
        print(f"[ab] host time of one fused_update call, n {n} B {B}, {label}: "
              f"least {min(us):.2f} us, median {float(np.median(us)):.2f} us "
              f"of {rounds} rounds ({card})")


def _snapshot(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its strides and offset: its whole storage
    copied, the view taken again (a broadcast view stays broadcast)."""
    flat = torch.tensor([], dtype=t.dtype, device=t.device).set_(
        t.untyped_storage())
    return flat.clone().as_strided(t.shape, t.stride(), t.storage_offset())


def colfetch_rowwise_sets(user_dir: str, calls: int = 8) -> list:
    """The first ``calls`` row-wise lookups of colfetch 1080p frames
    after two, each ``(tabs, idx)`` copied as the interpreter hands it
    to ``ops.lookup.rowwise_lookup`` (the main path's own index planes,
    tables and strides). Two a frame, on fresh audio each frame, so the
    sets rotate through more than the 50 MB L2 holds."""
    from glava_tpu_torch.ops import lookup

    _, _, frame = _frame_ms((1920, 1080), "colfetch", user_dir, 2)
    got = []
    real = lookup.rowwise_lookup

    def spy(tabs, idx):
        tabs = tuple(tabs)
        got.append((tuple(_snapshot(t) for t in tabs), _snapshot(idx)))
        return real(tabs, idx)

    lookup.rowwise_lookup = spy
    try:
        while len(got) < calls:
            frame()
    finally:
        lookup.rowwise_lookup = real
    torch.cuda.synchronize()
    return got[:calls]


def _sets_shape(sets) -> tuple[int, int, int]:
    """(N, T, P) of row-wise lookup sets (the same in every set)."""
    (tabs, idx), *_ = sets
    return idx.shape[0], tabs[0].shape[1], idx.shape[1]


def frames_side() -> None:
    """One side of ``frames_ab``, in a process whose ``glava_tpu_torch``
    is that side's tree: builds its kernels, times its row-wise lookup
    at C = 4 (its own wrapper and kernel, held torch.equal to its plain
    version first) on the colfetch 1080p frame's own inputs and on a
    random plane, then prints one JSON line of frame times (ms; the
    colfetch device time and the row-wise lookup in us)."""
    from glava_tpu_torch.ops import _build, lookup

    _build.load_all()
    out = {}
    with tempfile.TemporaryDirectory() as td:
        ud = str(write_shader_modules(Path(td)))
        for plane, sets in (("colfetch planes", colfetch_rowwise_sets(ud)),
                            ("random plane", _rowwise_sets(4, "random"))):
            K = len(sets)
            for tabs, idx in sets[:2]:
                if not all(torch.equal(g, w) for g, w in zip(
                        lookup.rowwise_lookup(tabs, idx),
                        lookup.rowwise_lookup_plain(tabs, idx))):
                    raise AssertionError(f"rowwise C=4 {plane}: kernel != plain")
            out[f"rowwise C=4 {plane} us"] = 1e3 * event_ms(
                lambda i: lookup.rowwise_lookup(*sets[i % K]), 100)
            del sets
        out["colfetch 1080p"], _, frame = _frame_ms((1920, 1080), "colfetch",
                                                    ud, 20)
        _, out["colfetch 1080p device us"] = _profile(frame, "", "", 10, False)
    out["bars 800x600"] = _frame_ms(None, "bars")[0]
    for n in (1, 64):
        out[f"fleet S {n} 800x600"] = _fleet_times(n, None, 20, "")
    out["fleet S 64 1920x1080"] = _fleet_times(64, (1920, 1080), 3, "")
    # without pipe values, which a tree before the circle's stream axis
    # refuses in a circle fleet
    for screen, label in ((None, "800x600"), ((1920, 1080), "1920x1080")):
        out[f"circle fleet S 64 {label}"] = _fleet_times(
            64, screen, 10, "", module="circle", pipe=False)
    out["circle 1080p Engine"] = _engine_ms("circle", (1920, 1080), 60)
    print(json.dumps(out))


def _engine_ms(module: str, screen, frames: int) -> float:
    """Host-clock ms a frame of ``Engine.run`` with a null sink, after a
    warm-up, through the tree's own frame fetch."""
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions
    from glava_tpu_torch.runtime.sinks import NullSink

    eng = Engine(EngineOptions(audio_backend="synth", screen=screen,
                               force_module=module, device="cuda",
                               requests=("setprintframes false",)),
                 sink=NullSink())
    eng.run(max_frames=10)
    eng.frames_rendered = 0
    return host_ms(lambda i: eng.run(max_frames=frames), 1, warmup=0) / frames


def frames_ab(parent: Path, card: str, pairs: int = 8) -> None:
    """The parent tree beside this one: ``pairs`` pairs of processes,
    one a side (``frames_side`` run with that tree's package first on
    the path, so each side times its own wrappers and kernels), the
    first side alternating. Prints every pair and the medians."""
    child = ("import importlib.util, sys; sys.path.insert(0, sys.argv[1]); "
             "spec = importlib.util.spec_from_file_location('smoke_ab', "
             "sys.argv[2]); m = importlib.util.module_from_spec(spec); "
             "sys.modules['smoke_ab'] = m; spec.loader.exec_module(m); "
             "m.frames_side()")
    runs = {"parent": [], "this": []}
    for p in range(pairs):
        order = (("parent", parent), ("this", ROOT))
        for name, root in order if p % 2 == 0 else order[::-1]:
            proc = subprocess.run([sys.executable, "-c", child, str(root),
                                   str(ROOT / "chip_smoke.py")], cwd=root,
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"frames_side {name}: rc {proc.returncode}\n"
                                   f"{proc.stderr[-4000:]}")
            runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(f"[ab] pair {p} {name}: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in runs[name][-1].items()),
                  flush=True)
    for key in runs["this"][0]:
        med = {name: float(np.median([r[key] for r in rs]))
               for name, rs in runs.items()}
        better = sum(t[key] < q[key] for t, q in zip(runs["this"], runs["parent"]))
        print(f"[ab] {key} median of {pairs}: parent {med['parent']:.3f}, this "
              f"{med['this']:.3f}; this lower in {better} of {pairs} pairs "
              f"({card})")


# (n, B) of the fused update's timed shapes: the one-cluster route at
# the shipped 4096 and its larger sizes, the split route above 65536
FUSED_TIMED = tuple((n, B) for n in (4096, 16384, 32768, 65536, 131072, 262144)
                    for B in (2, 128)) + ((524288, 2),)


def _lookup_times():
    """Device time per call of the lookup on circle's 1080p planes."""
    from glava_tpu_torch.ops import lookup

    lk = _module_lookup("circle", (1920, 1080))
    tab = torch.as_tensor(np.random.default_rng(4).random(lk.table_size,
                                                          dtype=np.float32),
                          device="cuda")
    flat = lk.idx.reshape(-1)
    P = lk.idx.numel()
    return {"ms": device_ms(lambda: lookup.table_lookup(tab, lk.idx)),
            "plain_ms": device_ms(lambda: lookup.table_lookup_plain(tab, lk.idx)),
            "library_ms": device_ms(lambda: torch.index_select(tab, 0, flat)),
            "bound_ms": bound_ms(lk.table_size * 4 + 2 * P * 4),
            "what": f"circle 1920x1080 ({P} points, T {lk.table_size}); "
                    "library torch.index_select"}


def rowwise_bytes(C: int, shape=ROWWISE_SHAPE) -> int:
    """Bytes the row-wise lookup must move, for every index pattern: the
    index plane and the C tables read once, the C outputs written once
    (the Pallas kernels' CostEstimate)."""
    N, T, P = shape
    return 4 * (N * P + C * (N * T + N * P))


def _rowwise_sets(C: int, pattern: str) -> list:
    """Input sets at ``ROWWISE_SHAPE`` on .T views, more of them than the
    50 MB L2 holds together, so a rotation gives each call fresh inputs."""
    K = max(2, -(-2 * 64 * 2 ** 20 // rowwise_bytes(C)))
    return [rowwise_inputs(C, "T views", pattern, seed=seed) for seed in range(K)]


def _rowwise_times(user_dir: str):
    """Time per call at 1080p on ``.T`` views, C in {1, 4} (the column
    fetch at a run-time row takes C = 4), every index pattern, and C = 4
    on the colfetch 1080p frame's own inputs (``colfetch_rowwise_sets``;
    key ``(4, "colfetch")``): kernel, plain version and library call (C
    gathers, int64 index made once) by CUDA events around back-to-back
    calls on fresh inputs (the plain version, which syncs to check its
    indices, by events around a loop of calls on one input set)."""
    from glava_tpu_torch.ops import lookup

    out = {}
    cases = [(C, p, lambda C=C, p=p: _rowwise_sets(C, p))
             for C in (1, 4) for p in ROWWISE_PATTERNS]
    cases.append((4, "colfetch", lambda: colfetch_rowwise_sets(user_dir)))
    for C, pattern, make in cases:
        sets = make()
        for tabs, idx in sets:
            if not all(torch.equal(g, w) for g, w in zip(
                    lookup.rowwise_lookup(tabs, idx),
                    lookup.rowwise_lookup_plain(tabs, idx))):
                raise AssertionError(f"rowwise C={C} {pattern}: kernel != plain")
        K = len(sets)
        shape = _sets_shape(sets)
        longs = [idx.long() for _, idx in sets]
        plan = lookup.rowwise_plan(C, shape[1], shape[2], sets[0][1].stride())
        out[C, pattern] = {
            "ms": event_ms(lambda i: lookup.rowwise_lookup(*sets[i % K]), 100),
            # the plain version checks its indices on the host, a sync
            # each call: events around a loop of calls
            "plain_ms": cuda_ms(lambda: lookup.rowwise_lookup_plain(*sets[0]), 10),
            "library_ms": event_ms(lambda i: [
                torch.gather(t, 1, longs[i % K]) for t in sets[i % K][0]], 20),
            "bound_ms": bound_ms(rowwise_bytes(C, shape)),
            "what": f"C {C}, (N, T, P) {shape}, "
                    + ("the colfetch 1080p frame's own inputs" if
                       pattern == "colfetch" else f"{pattern} index plane, .T views")
                    + f", route {plan.route} {plan.strip}, CUDA events, back to "
                    f"back, {K} input sets in turn; library torch.gather x{C} "
                    "(int64 index made once)"}
    return out


def _latch_times():
    """Time per call at (1081, 1920): C = 0 prefix max (where one
    library call, torch.cummax, computes the same key scan) and C = 4
    suffix min. Kernel and library: CUDA events around back-to-back
    calls on fresh inputs (a rotation of input sets larger than the
    50 MB L2), and the profiler's device time on one warm set beside
    it; the plain version from the profiler."""
    from glava_tpu_torch.ops import latch

    E, W = LATCH_SHAPE
    out = {}
    for C, reverse in ((0, False), (4, True)):
        nbytes = 2 * (1 + C) * E * W * 4
        K = max(2, -(-2 * 64 * 2 ** 20 // nbytes))
        sets = [latch_inputs(C, reverse, seed) for seed in range(K)]
        key, cands, sent = sets[0]
        out[C] = {
            "ms": event_ms(lambda i: latch.latch_scan(*sets[i % K][:2], reverse,
                                                      sent), 100),
            "warm_ms": device_ms(lambda: latch.latch_scan(key, cands, reverse,
                                                          sent)),
            "plain_ms": device_ms(
                lambda: latch.latch_scan_plain(key, cands, reverse, sent), 3),
            "library_ms": (event_ms(lambda i: torch.cummax(sets[i % K][0], 0),
                                    100) if C == 0 else None),
            "bound_ms": bound_ms(nbytes),
            "what": f"C {C}, {'suffix min' if reverse else 'prefix max'}, "
                    f"({E}, {W}), CUDA events, back to back, {K} input sets "
                    "in turn" + ("; library torch.cummax" if C == 0 else "")}
    return out


def _frame_ms(screen, module="bars", user_dir=None, iters=200, requests=(),
              compiled: bool = False, pipe: bool = False):
    """CUDA events around ``iters`` frames of ``module`` (fresh audio on
    the card, the update every frame, uint8, ``FrameFetch`` to the host)
    by the eager ``step_u8`` or, ``compiled``, by ``jit_step``; with
    ``pipe``, a new ``fg`` value every frame; -> (ms a frame, renderer,
    the frame function)."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.renderer import Renderer

    r = Renderer(loader.load(cli_requests=requests, force_module=module,
                             user_dir=user_dir),
                 screen=screen, device="cuda")
    rng = np.random.default_rng(2)
    audio = torch.as_tensor(rng.standard_normal((64, 2, 4096)) * 0.3,
                            dtype=torch.float32, device="cuda")
    box = {"s": r.init_state(), "k": 0}
    to_host = _to_host()
    step = r.jit_step(quantize=True) if compiled else r.step_u8

    def frame():
        k = box["k"]
        write = ({"fg": np.float32([0.3 + 0.001 * (k % 500), 0.8, 0.4, 1.0])}
                 if pipe else None)
        box["s"], f = step(box["s"], audio[k % 64], True, 0.0, 1.0, 0.05,
                           write)
        box["k"] += 1
        return to_host(f)

    return cuda_ms(frame, iters), r, frame


def _to_host():
    """The tree's own way to bring one frame to the host, synchronously:
    ``FrameFetch`` at depth 0 (a pinned side-stream copy) where the tree
    has it, else a pageable ``.cpu()`` (a parent tree under ``--ab``)."""
    try:
        from glava_tpu_torch.runtime.engine import FrameFetch
    except ImportError:
        return lambda f: f.cpu()
    ff = FrameFetch("cuda", 0)
    return lambda f: ff.push(f, 0.0)[0][0]


def _profile(frame, label: str, card: str, frames: int = 50,
             show: bool = True) -> tuple[float, float]:
    """Device busy share of ``frames`` calls of ``frame`` under
    torch.profiler (device rows only) and the device microseconds a
    call, with the top kernels printed when ``show``; (0.0, 0.0) when
    the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_us = host_ms(lambda i: frame(), frames, warmup=0) * frames * 1e3
    # device rows only: an op's row (device type CPU) also carries the
    # device time of the kernels it launched, so summing every row
    # counts most device time twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    if busy <= 0:
        print(f"[5 times] profile {label}: no device time recorded (not measured)")
        return 0.0, 0.0
    if show:
        share = ", ".join(f"{e.key[:48]} {e.self_device_time_total / busy:.0%}"
                          for e in top)
        print(f"[5 times] profile {frames} frames {label}: device busy "
              f"{busy / wall_us:.1%} of {wall_us / frames:.0f} us/frame wall, "
              f"{busy / frames:.0f} us/frame device; kernel share: {share} "
              f"({card})")
    return busy / wall_us, busy / frames


def _print_kernel_time(name: str, t: dict, card: str) -> None:
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms'] * 1e3:.2f} us")
    print(f"[5 times] {name} {t['what']}: device time kernel "
          f"{t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"library {lib}, bound {t['bound_ms'] * 1e3:.2f} us (bytes) ({card})")


def _while_times() -> dict:
    """The while setter on 1920x1080 active planes with no pixel set (it
    reads every byte), 32 planes in turn (64 MB, past the L2), against
    its plain version; bytes: the plane, the fuel, the two sync words
    and ``go``."""
    from glava_tpu_torch.ops import graph_while

    planes = [torch.zeros((1080, 1920), dtype=torch.bool, device="cuda")
              for _ in range(32)]
    fuel = torch.zeros(1, dtype=torch.int32, device="cuda")
    sync = torch.zeros(2, dtype=torch.int32, device="cuda")
    go = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = event_ms(lambda i: graph_while.set_condition(
        planes[i % 32], fuel, WHILE_CAP, sync, go), 200)
    plain = event_ms(lambda i: graph_while.condition_plain(
        planes[i % 32], fuel, WHILE_CAP), 200)
    return {"what": "1920x1080 plane, no pixel active", "ms": ms,
            "plain_ms": plain, "library_ms": None,
            "bound_ms": bound_ms(planes[0].numel() + 4 + 8 + 4),
            "bound_by": "bytes"}


def _raster_times(S: int, H: int, W: int):
    """bars_raster at S streams of H x W, per-stream colours: event
    times of the kernel (4 input sets in turn) and its plain version."""
    from glava_tpu_torch.ops import raster

    sets = [raster_inputs(S, H, W, False, seed) for seed in range(4)]
    # written once: the (S, 4, H, W) planes; read once: v, inner, d and
    # the two colour tables
    nbytes = S * 4 * H * W * 4 + S * W * 4 + W + H * 4 + 2 * S * H * 16
    return {"ms": event_ms(lambda i: raster.bars_raster(*sets[i % 4], 1.0, True),
                           100),
            "plain_ms": event_ms(
                lambda i: raster.bars_raster_plain(*sets[i % 4], 1.0, True), 20),
            "library_ms": None, "bound_ms": bound_ms(nbytes),
            "what": f"S {S} {W}x{H}, outlined, per-stream colours (CUDA "
                    "events, back to back); no library call computes it"}


def _smooth_times(card: str) -> dict:
    """smooth_scan at the main path's shape (a shader module's one
    stateless uniform at bufsize 4096: 1 row, sz 4096, the default
    ratio 4 and distance 0.01) by CUDA events on 8 live rows in turn
    (``smooth_live_rows``: every smoothed bin finite and nonzero),
    its plain version beside it; the kernel alone at the other checked
    shapes. Bound: bytes, each row read once and written once, and the
    window table."""
    from glava_tpu_torch.ops import smooth

    out = None
    for sz, ratio, d in ((4096, 4.0, 0.01),) + tuple(
            c for c in SMOOTH_CASES if c != (4096, 4.0, 0.01)):
        sets = [torch.as_tensor(x, device="cuda")
                for x in smooth_live_rows(sz, 8)]
        asz = -(-sz // int(ratio))
        for i, x in enumerate(sets):
            _check_live(smooth.smooth_transform(x, ratio, d), asz,
                        f"smooth_scan sz {sz} ratio {ratio} d {d} set {i}")
        nbytes = 2 * sz * 4 + asz * 8
        ms = event_ms(lambda i: smooth.smooth_transform(sets[i % 8], ratio, d),
                      20 if sz > 4096 else 100)
        line = (f"[5 times] smooth_scan 1 row sz {sz} ratio {ratio:g} d {d:g} "
                f"({asz} bins walked): kernel {ms * 1e3:.2f} us (CUDA events, "
                f"back to back, 8 input sets in turn), {ms * 1e6 / asz:.1f} ns a "
                f"bin, bound {bound_ms(nbytes) * 1e3:.3f} us (bytes)")
        if out is None:
            # ~7 launches a bin: more than the launch queue holds behind
            # event_ms's spin kernel, so CUDA events around whole calls
            # (launch-bound, as the eager loop runs)
            plain = cuda_ms(lambda: smooth.smooth_transform_plain(
                sets[0], ratio, d), 3)
            out = {"ms": ms, "plain_ms": plain, "library_ms": None,
                   "bound_ms": bound_ms(nbytes),
                   "what": f"1 row, sz {sz}, ratio {ratio:g}, d {d:g}"}
            line += (f", plain {plain * 1e3:.2f} us (CUDA events around 3 "
                     "calls); library none")
        print(f"{line} ({card})")
    return out


def _mel_times(card: str) -> None:
    """log_mel of the 30 s clip: CUDA events with the frames on the card,
    and the host clock from host frames (the copy in, the features left
    on the card, synchronised)."""
    from glava_tpu_torch.models import mel

    frames = mel_frames()
    dev = torch.as_tensor(frames, device="cuda")
    ms = cuda_ms(lambda: mel.log_mel(dev), 20)
    host = float(np.median([
        host_ms(lambda i: mel.log_mel(frames, device="cuda"), 1, warmup=0)
        for _ in range(5)]))
    n = frames.shape[0]
    print(f"[5 times] log_mel {n} frames x 512 -> 80 mels: {ms:.3f} ms on the "
          f"card = {n / ms * 1e3:.0f} frames/s (CUDA events, frames on the "
          f"card); {host:.3f} ms = {n / host * 1e3:.0f} frames/s from host "
          f"frames (host clock, median of 5) ({card})")


def _fleet_times(n: int, screen, frames: int, card: str,
                 breakdown: bool = False, module: str = "bars",
                 pipe: bool = True, eager: bool = False) -> float:
    """One fleet frame as ``FleetEngine.run`` makes it (host snapshots to
    the card, the step, the uint8 frames back through
    ``FleetEngine.fetch``), n streams of ``module`` with their own
    colours (``pipe``), every stream updating: the host clock per frame,
    CUDA events around the step (the snapshot copy and the kernels,
    with any idle gaps) and around the frame copy, and the device busy
    share under the profiler. The engine's step is its compiled step, or
    with ``eager`` the eager fleet step in its place."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.runtime.fleet import FleetEngine

    eng = FleetEngine(loader.load(force_module=module),
                      _fleet_streams(n, pipe=pipe), screen=screen,
                      device="cuda")
    if eager:
        eng._step = lambda *a: eng.br.step(*a, quantize=True)
    cfg = eng.loaded.cfg
    rng = np.random.default_rng(2)
    pool = [(rng.standard_normal((n, 2, cfg.bufsize)) * 0.3).astype(np.float32)
            for _ in range(4)]
    mods, interp = np.ones(n, bool), np.ones(n, np.float32)
    g = np.full(n, cfg.gravity_step / cfg.nominal_ups, np.float32)
    box = {"k": 0}
    # the fleet's own copy: pinned, one synchronize (a parent tree
    # without FleetEngine.fetch copies pageable, as its run does)
    fetch = getattr(eng, "fetch", lambda f: f.cpu().numpy())

    def frame():
        box["k"] += 1
        return fetch(eng.step(pool[box["k"] % 4], mods, 0.0, interp, g))

    for _ in range(2):
        frame()
    torch.cuda.synchronize()
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(frames)]
    t0 = time.perf_counter()
    for e in ev:
        box["k"] += 1
        e[0].record()
        out = eng.step(pool[box["k"] % 4], mods, 0.0, interp, g)
        e[1].record()
        fetch(out)
        e[2].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / frames
    step = sum(e[0].elapsed_time(e[1]) for e in ev) / frames
    copy = sum(e[1].elapsed_time(e[2]) for e in ev) / frames
    w, h = eng.br.screen
    label = (f"{module} fleet S {n} {w}x{h}"
             f"{' eager' if eager else ' compiled'}")
    busy, _ = _profile(frame, label, card, frames=3 if n > 8 else 10,
                       show=breakdown)
    mb = n * w * h * 4 / 1e6
    print(f"[5 times] {label} frame: {wall:.3f} ms host clock = "
          f"{1e3 / wall:.1f} fps x {n} streams; step {step:.3f} ms, frame copy "
          f"{copy:.3f} ms ({mb:.1f} MB, {mb / copy:.2f} GB/s) (CUDA events); "
          f"device busy {busy:.1%} ({card})")
    return wall


def _sharded_fleet_times(card: str, user_dir: str, kind: str = "bars",
                         n: int = 64, screen=None, meshes=None,
                         frames: int = 20) -> None:
    """A fleet frame (``FleetEngine.step`` + ``fetch``) of ``n``
    streams of ``kind`` on the unsharded engine and on every mesh of
    ``meshes`` (by default ``shard_meshes``), each by its compiled step
    and by the eager step in its place, by the host clock, split into
    the step (every device's launches and their completion on every
    device) and the pinned copy into the one host buffer, with the
    copy's rate; engines in turn, two rounds."""
    meshes = shard_meshes() if meshes is None else meshes
    engines = [("unsharded", _fleet_engine(kind, n, user_dir, screen=screen))] + [
        (label, _fleet_engine(kind, n, user_dir, devices, screen, kw))
        for label, devices, kw in meshes]
    for label, _ in list(engines):
        devices, kw = next(((d, k) for lb, d, k in meshes if lb == label),
                           (None, None))
        eng = _fleet_engine(kind, n, user_dir, devices, screen, kw)
        eng._step = functools.partial(eng.br.step, quantize=True)
        engines.append((f"{label} eager", eng))
    cfg = engines[0][1].loaded.cfg
    w, h = engines[0][1].br.screen
    rng = np.random.default_rng(2)
    pool = [(rng.standard_normal((n, 2, cfg.bufsize)) * 0.3).astype(np.float32)
            for _ in range(4)]
    mods, interp = np.ones(n, bool), np.ones(n, np.float32)
    g = np.full(n, cfg.gravity_step / cfg.nominal_ups, np.float32)
    res = {label: [] for label, _ in engines}
    for rnd in range(2):
        for label, eng in (engines if rnd == 0 else engines[::-1]):
            for k in range(3):
                eng.fetch(eng.step(pool[k % 4], mods, 0.0, interp, g))
            synchronize()
            step = copy = 0.0
            for k in range(frames):
                t0 = time.perf_counter()
                out = eng.step(pool[k % 4], mods, 0.0, interp, g)
                synchronize()
                t1 = time.perf_counter()
                eng.fetch(out)
                copy += time.perf_counter() - t1
                step += t1 - t0
            res[label].append((step * 1e3 / frames, copy * 1e3 / frames))
    mb = n * w * h * 4 / 1e6
    for label, runs in res.items():
        st = [a for a, _ in runs]
        cp = [b for _, b in runs]
        print(f"[5 times] {kind} fleet S {n} {w}x{h} {label}: frame "
              f"{np.mean(st) + np.mean(cp):.3f} ms host clock = step "
              f"{np.mean(st):.3f} ms (rounds {', '.join(f'{v:.3f}' for v in st)}) "
              f"+ pinned copy {np.mean(cp):.3f} ms (rounds "
              f"{', '.join(f'{v:.3f}' for v in cp)}; {mb:.1f} MB, "
              f"{mb / np.mean(cp):.2f} GB/s) ({card})")


def _circle_mesh_times(card: str, user_dir: str) -> None:
    """The S 64 circle fleet at 1920x1080 (device-bound unsharded) on a
    rows mesh of the first card twice (what the band copies cost: the
    pinned copy's rate on a rows mesh) and, where several cards are
    visible, on every card on the streams axis and on rows 2."""
    count = torch.cuda.device_count()
    cards = [f"cuda:{i}" for i in range(count)]
    meshes = [("[cuda:0] x 2 rows 2", ["cuda:0"] * 2, {"rows": 2})]
    if count > 1:
        meshes.append((f"every card [cuda:0 .. cuda:{count - 1}]", cards, {}))
    if count > 1 and count % 2 == 0:
        meshes.append((f"every card [cuda:0 .. cuda:{count - 1}] rows 2",
                       cards, {"rows": 2}))
    _sharded_fleet_times(card, user_dir, "circle", 64, (1920, 1080), meshes,
                         frames=8)
    if count == 1:
        print("[5 times] circle fleet S 64 1920x1080 over several cards "
              "(streams mesh against rows mesh): not measured, one card "
              f"visible ({card})")


def _compiled_times(card: str, user_dir: str) -> None:
    """Eager against captured, side by side in this process: each native
    module's frame at 800x600 and circle's at 1920x1080, each GLSL
    shader module's at 800x600 and rings' and colfetch's at 1920x1080,
    and bars with a pipe write every frame (the update every frame,
    uint8, ``FrameFetch`` to the host): the host clock and the device
    time a frame and the device's busy share under the profiler, each
    kernel's device time (the while setter's launches a frame too), and
    CUDA events around the frames; the user Python module vu_meter's
    frame at 800x600 the same way; the split
    route's update (n 131072, B 2) in and out of a graph; the S 64 bars
    and circle fleets at both sizes."""
    cases = ([(m, None, False) for m in MODULES]
             + [("circle", (1920, 1080), False), ("bars", None, True)]
             + [(m, None, False) for m in SHADER_MODULES]
             + [(m, (1920, 1080), False) for m in SHADER_1080]
             + [("vu_meter", None, False)])
    vu_dir = tempfile.TemporaryDirectory()
    dirs = {"vu_meter": _vu_root(Path(vu_dir.name))}
    dirs.update(dict.fromkeys(SHADER_MODULES, user_dir))
    for module, screen, pipe in cases:
        row = {}
        shader = module in SHADER_MODULES
        names = list(dict.fromkeys(
            KERNEL_NAMES[k] for k in ("fused_update", *LAUNCHES[module],
                                      *DATA_LAUNCHES.get(module, ()))))
        if module in NO_FFT:
            names = names[1:]
        for mode in ("eager", "captured"):
            ms, r, frame = _frame_ms(screen, module, dirs.get(module),
                                     iters=20 if shader else 100,
                                     compiled=mode == "captured", pipe=pipe)
            busy, dev_us = _profile(frame, f"{module} {mode}", card,
                                    show=False)
            each = kernel_ms(frame, names, 20) if names else {}
            parts = [f"{k} {v * 1e3:.2f} us" for k, v in each.items()]
            if "graph_while" in DATA_LAUNCHES.get(module, ()):
                n, us = _setter_profile(frame, 10)
                parts.append(f"while setter {n:.1f} launches, {us:.2f} us a "
                             f"launch")
            row[mode] = (dev_us / busy if busy else float("nan"), dev_us,
                         busy, ms * 1e3, ", ".join(parts))
        w, h = r.screen
        (we, de, be, ee, ke), (wc, dc, bc, ec, kc) = (row["eager"],
                                                      row["captured"])
        print(f"[5 times] compiled {module} {w}x{h} frame"
              f"{' with a pipe write every frame' if pipe else ''} (update + "
              f"raster + uint8 + FrameFetch): eager {we:.1f} us wall, {de:.1f} us "
              f"device, busy {be:.1%}, {ee:.1f} us by CUDA events"
              f"{f' ({ke}, profiler)' if ke else ''}; captured "
              f"{wc:.1f} us wall, {dc:.1f} us device, busy {bc:.1%}, "
              f"{ec:.1f} us by CUDA events{f' ({kc}, profiler)' if kc else ''}"
              f"; wall eager/captured {we / wc:.2f}x ({card})")
    vu_dir.cleanup()
    _split_graph_times(card)
    for module, screen, count in (("bars", None, 20),
                                  ("bars", (1920, 1080), 5),
                                  ("circle", None, 10),
                                  ("circle", (1920, 1080), 5)):
        for eager in (True, False):
            _fleet_times(64, screen, count, card, module=module, eager=eager)


def _split_graph_times(card: str, n: int = SPLIT_N, B: int = 2) -> None:
    """The split route's update at bufsize ``n``, B rows, on
    ``_update_sets``' input sets in turn: eager (``fused.fused_update``,
    two launches, the second a programmatic dependent) and replayed from
    one CUDA graph a set holding that call (its programmatic edge a
    graph edge): each of its two kernels' profiler device time, the
    call's device time (CUDA events behind a spin) and its host time;
    then ``AudioPipeline.jit_update``'s call on fresh device inputs (two
    copies in, the replay) by the same three."""
    from dataclasses import replace

    from glava_tpu_torch import compiled
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.ops import fused
    from glava_tpu_torch.pipeline import AudioPipeline, UniformSpec

    sets = _update_sets(n, B)
    K = len(sets)
    saved = compiled.read_counters()
    graphs = []
    for args in sets:
        fused.fused_update(*args)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fused.fused_update(*args)
        graphs.append(g)
    cfg = replace(loader.load().cfg, bufsize=n, smooth_pass=False)
    chain = ("window", "fft", "gravity", "avg")
    pipe = AudioPipeline(cfg, [UniformSpec("audio_l", "audio_l", chain),
                               UniformSpec("audio_r", "audio_r", chain)],
                         device="cuda")
    rng = np.random.default_rng(5)
    feeds = [torch.as_tensor(rng.standard_normal((B // 2, 2, n)) * 0.3,
                             dtype=torch.float32, device="cuda")
             for _ in range(4)]
    gravity = np.float32(cfg.gravity_step / cfg.nominal_ups)
    upd = pipe.jit_update()
    box = {"st": pipe.init_state((B // 2,)), "k": 0}

    def update(i=None):
        a = feeds[box["k"] % 4]
        box["k"] += 1
        box["st"], _ = upd(box["st"], a[:, 0], a[:, 1], None, None, gravity)

    # the jit_update call waits for its staging ring when the host runs
    # ahead, so it is not queued behind a spin: events around the calls
    runs = {"eager": (lambda i=0: fused.fused_update(*sets[i % K]),
                      event_ms, "behind a spin"),
            "in a graph": (lambda i=0: graphs[i % K].replay(), event_ms,
                           "behind a spin"),
            "jit_update call": (update, lambda fn, k: cuda_ms(fn, k),
                                "back to back")}
    out = {}
    for label, (fn, timer, how) in runs.items():
        each = kernel_ms(fn, SPLIT_KERNELS, 20)
        out[label] = (each, timer(fn, 100), how, host_ms(fn, 200))
    compiled._restore_counters(saved)
    print(f"[5 times] split route n {n} B {B} update ({K} input sets in "
          "turn): " + "; ".join(
              f"{label}: " + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in
                                       each.items())
              + f" (profiler), {ev * 1e3:.2f} us a call by CUDA events "
                f"{how}, {ho * 1e3:.2f} us a call host clock"
              for label, (each, ev, how, ho) in out.items()) + f" ({card})")


def phase_times(card: str, user_dir: str) -> dict:
    from glava_tpu_torch.ops import latch

    times = {}
    for n, B in FUSED_TIMED:
        dk, dp, prof, each, nbytes, K = _update_times(n, B)
        bound, by, ops_ms = fused_bound(n, B, nbytes)
        times[n, B] = {"ms": dk, "plain_ms": dp, "library_ms": None,
                       "bound_ms": bound, "bound_by": by}
        route = " (split route)" if n > 65536 else ""
        if each:
            route += " (" + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in
                                      each.items()) + " on one warm set)"
        print(f"[5 times] fused update n{n} B{B}{route}: kernel "
              f"{dk * 1e3:.2f} us, plain {dp * 1e3:.2f} us (CUDA events, back "
              f"to back, {K} input sets in turn), bound {bound * 1e3:.3f} us "
              f"({by}; bytes {bound_ms(nbytes) * 1e3:.3f} us, float64 FFT "
              f"operations {ops_ms * 1e3:.3f} us), {bound / dk:.1%} of it; "
              f"profiler device time of the kernel on one warm set "
              f"{prof * 1e3:.2f} us; library none ({card})")
    raster_t = {(H, W): _raster_times(64, H, W) for H, W in ((600, 800), (1080, 1920))}
    for t in raster_t.values():
        _print_kernel_time("bars_raster", t, card)
    out = {"fused_update": times[4096, 2],
           "fused_update split": times[131072, 2],
           "table_lookup": _lookup_times(),
           "bars_raster": raster_t[(600, 800)]}
    _print_kernel_time("table_lookup", out["table_lookup"], card)
    for (C, pattern), t in _rowwise_times(user_dir).items():
        # the main path's own inputs where it has them (C = 4)
        if pattern == ("colfetch" if C == 4 else "random"):
            out[f"rowwise_lookup C={C}"] = t
        _print_kernel_time("rowwise_lookup", t, card)
    for C, t in _latch_times().items():
        out[f"latch_scan C={C}"] = t
        _print_kernel_time("latch_scan", t, card)
        print(f"[5 times] latch_scan C {C}: profiler device time on one warm "
              f"input set {t['warm_ms'] * 1e3:.2f} us ({card})")
    for C, reverse in ((0, False), (4, True)):
        # the 800x600 walk's plane: a fixed cost per call against its bytes
        shape = (601, 800)
        nbytes = 2 * (1 + C) * shape[0] * shape[1] * 4
        K = max(2, -(-2 * 64 * 2 ** 20 // nbytes))
        sets = [latch_inputs(C, reverse, seed, shape=shape) for seed in range(K)]
        ms = event_ms(lambda i: latch.latch_scan(*sets[i % K][:2], reverse,
                                                 sets[i % K][2]), 100)
        print(f"[5 times] latch_scan C {C} at {shape}: {ms * 1e3:.2f} us (CUDA "
              f"events, back to back, {K} input sets in turn), bound "
              f"{bound_ms(nbytes) * 1e3:.2f} us (bytes) ({card})")
    out["smooth_scan"] = _smooth_times(card)
    _print_kernel_time("smooth_scan", out["smooth_scan"], card)
    out["graph_while"] = _while_times()
    _print_kernel_time("graph_while", out["graph_while"], card)
    for reqs in CPU_PATH_RUNS:
        ms8 = _frame_ms(None, "bars", requests=reqs)[0]
        ms10 = _frame_ms((1920, 1080), "bars", requests=reqs)[0]
        print(f"[5 times] bars frame {', '.join(reqs)} (update every frame, "
              f"chain route + raster + uint8 + FrameFetch to the host) "
              f"800x600: {ms8:.3f} ms = {1e3 / ms8:.1f} fps; 1920x1080: "
              f"{ms10:.3f} ms = {1e3 / ms10:.1f} fps ({card})")
    _mel_times(card)
    frames = {}
    for module in ("bars", "radial", "circle") + tuple(SHADER_MODULES):
        shader = module in SHADER_MODULES
        ud = user_dir if shader else None
        iters = 20 if shader else 200
        ms8, _, f8 = _frame_ms(None, module, ud, iters)
        ms10, _, f10 = _frame_ms((1920, 1080), module, ud, iters)
        frames[module] = (f8, f10)
        print(f"[5 times] {module} frame (update + raster + uint8 + FrameFetch "
              f"to the host) "
              f"800x600: {ms8:.3f} ms = {1e3 / ms8:.1f} fps; 1920x1080: "
              f"{ms10:.3f} ms = {1e3 / ms10:.1f} fps ({card})")
    _profile(frames["bars"][0], "bars 800x600", card)
    _profile(frames["circle"][1], "circle 1920x1080", card)
    _profile(frames["aawalk"][1], "aawalk 1920x1080", card, frames=10)
    _profile(frames["colfetch"][1], "colfetch 1920x1080", card, frames=10)
    for n in (1, 8, 64):
        for screen, count in ((None, 20), ((1920, 1080), 5 if n == 64 else 10)):
            _fleet_times(n, screen, count, card,
                         breakdown=n == 64 and screen is None)
    for screen in (None, (1920, 1080)):
        _fleet_times(64, screen, 10, card, breakdown=screen is None,
                     module="circle")
    _sharded_fleet_times(card, user_dir)
    _circle_mesh_times(card, user_dir)
    _compiled_times(card, user_dir)
    return out


def _copy_ms(src: torch.Tensor, pinned: bool, reps: int) -> float:
    """Median milliseconds of one device-to-host copy of ``src`` (CUDA
    events): ``.cpu()`` into fresh pageable memory, as the port copied
    before, or ``copy_(non_blocking=True)`` into a pinned tensor."""
    dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True) \
        if pinned else None
    times = []
    for _ in range(reps + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        if pinned:
            dst.copy_(src, non_blocking=True)
        else:
            src.cpu()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


COPY_SIZES = (("RGBA8 1920x1080", 1920 * 1080 * 4),
              ("YUV420 1920x1080", 1920 * 1080 * 3 // 2),
              ("fleet S 64 RGBA8 1920x1080", 64 * 1920 * 1080 * 4))


def host_times(card: str) -> None:
    """Phase 5's host-runtime times: device-to-host copy rates pageable
    against pinned, Engine fps at 1920x1080 (bars, circle) for each
    wire and in-flight depth, and the 64-stream fleet loop on the native
    and the Python ring, on the host clock. The sinks drop the frames (a
    null sink declaring the wire), so the fps compare the wires and
    depths, not a writer."""
    from glava_tpu_torch.runtime import sinks
    from glava_tpu_torch.runtime.engine import Engine, EngineOptions

    class NullYuv(sinks.NullSink):
        wire_format = "yuv420"

    for label, n in COPY_SIZES:
        src = torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda")
        reps = 3 if n > 1e8 else 20
        page, pin = _copy_ms(src, False, reps), _copy_ms(src, True, reps)
        del src
        print(f"[5 times] copy {label} ({n / 1e6:.2f} MB) device to host: "
              f"pageable .cpu() {page:.3f} ms = {n / page / 1e6:.2f} GB/s, "
              f"pinned {pin:.3f} ms = {n / pin / 1e6:.2f} GB/s (CUDA events, "
              f"median of {reps}) ({card})")
    engines = {}
    for module in ("bars", "circle"):
        for wire in ("rgba8", "yuv420"):
            for depth in (0, 1, 2):
                sink = NullYuv() if wire == "yuv420" else sinks.NullSink()
                eng = engines[module, wire, depth] = Engine(EngineOptions(
                    audio_backend="synth", screen=HOST_SCREEN,
                    force_module=module, inflight=depth, device="cuda",
                    requests=("setprintframes false",)), sink=sink)
                if eng._wire[0] != wire:
                    raise AssertionError(f"{module}: wire {eng._wire}")
                eng.run(max_frames=10)
    # host times spread: every configuration once a round, ENGINE_ROUNDS
    # rounds, the median and the range printed
    ms = {key: [] for key in engines}
    for _ in range(ENGINE_ROUNDS):
        for key, eng in engines.items():
            eng.frames_rendered = 0
            ms[key].append(host_ms(lambda i: eng.run(max_frames=ENGINE_FRAMES),
                                   1, warmup=0) / ENGINE_FRAMES)
    for (module, wire, depth), t in ms.items():
        med = float(np.median(t))
        print(f"[5 times] Engine {module} 1920x1080 {wire} inflight {depth}: "
              f"{1e3 / med:.1f} fps = {med:.3f} ms a frame, median of "
              f"{ENGINE_ROUNDS} rounds of {ENGINE_FRAMES} frames (range "
              f"{min(t):.3f}-{max(t):.3f} ms; host clock, null sink) ({card})")
    # the fleet's host loop (64 synth capture threads, 64 ring snapshots
    # a frame) on the native seqlock ring against the Python ring
    ring_ms = {True: [], False: []}
    for _ in range(3):
        for native in (True, False):
            ring_ms[native].append(_fleet_run_ms(native))
    runs = {n: f"{np.median(t):.3f} ms a frame (runs "
               + " ".join(f"{x:.3f}" for x in t) + ")"
            for n, t in ring_ms.items()}
    print(f"[5 times] FleetEngine.run S 64 800x600, 20 frames, alternating: "
          f"native ring {runs[True]}, Python ring {runs[False]} (host "
          f"clock) ({card})")


def _fleet_run_ms(native: bool, frames: int = 20) -> float:
    import functools

    from glava_tpu_torch.config import loader
    from glava_tpu_torch.runtime import audio as audio_mod
    from glava_tpu_torch.runtime.fleet import FleetEngine

    make = audio_mod.make_audio_data
    audio_mod.make_audio_data = functools.partial(make, prefer_native=native)
    try:
        eng = FleetEngine(loader.load(), _fleet_streams(64), device="cuda")
    finally:
        audio_mod.make_audio_data = make
    if isinstance(eng.audio[0], audio_mod.NativeAudioData) != native:
        raise AssertionError(f"fleet ring: {type(eng.audio[0]).__name__}")
    eng.run(max_frames=3)
    eng.frames_rendered = 0
    return host_ms(lambda i: eng.run(max_frames=frames), 1, warmup=0) / frames


ENGINE_ROUNDS, ENGINE_FRAMES = 5, 60


# the TPU kernel each entry of PATH replaces
REPLACES = {
    "fused_update": "glava_tpu/ops/pallas/fused.py:712",
    "fused_update split": "glava_tpu/ops/pallas/fused.py:712",
    "table_lookup": "glava_tpu/ops/pallas/lookup.py:53,289,319",
    "rowwise_lookup C=4": "glava_tpu/ops/pallas/lookup.py:210",
    "latch_scan C=0": "glava_tpu/ops/pallas/latch.py:82",
    "latch_scan C=4": "glava_tpu/ops/pallas/latch.py:82",
    "bars_raster": "scripts/exp_pallas_bars.py:138",
    # no pallas_call: the counterpart of the JAX package's lax.scan
    "smooth_scan": "glava_tpu/ops/transforms.py:145",
    # no pallas_call: the counterpart of the JAX interpreter's
    # lax.while_loop
    "graph_while": "glava_tpu/config/glsl_shader.py:2147",
}


def main() -> int:
    card = phase_device()
    phase_build()
    errs = {"fused_update": phase_kernel(),
            "fused_update split": phase_split(),
            "table_lookup": phase_lookup(),
            "latch_scan": phase_latch(), "rowwise_lookup": phase_rowwise(),
            "bars_raster": phase_raster(), "smooth_scan": phase_smooth(),
            "graph_while": phase_while(card)}
    with tempfile.TemporaryDirectory() as td:
        user_dir = str(write_shader_modules(Path(td)))
        launches = phase_main_path(user_dir)
        phase_mel()
        phase_host(user_dir, Path(td))
        phase_entry_points(card)
        for line in phase_compiled(user_dir, Path(td)):
            print(f"[4 compiled] {line}")
        times = phase_times(card, user_dir)
        host_times(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"glava_tpu_torch/csrc/{name.split()[0]}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": errs.get(name, errs[name.split()[0]]),
        "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name].get("bound_by", "bytes"),
        "library_ms": times[name]["library_ms"],
    } for name in PATH]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def ab(parent: str) -> int:
    """``--ab PARENT``: the tree unpacked at PARENT (for example the
    parent commit) beside this checkout, on one card (``frames_ab``)."""
    card = phase_device()
    frames_ab(Path(parent).resolve(), card)
    return 0


# run in a process of another tree's own package (argv[1]): its row-wise
# lookup (staged, C 4, the 1080p .T views of the main path) and smooth
# scan (sz 4096, prefix tables in shared memory) on every card against
# their plain versions; a refused launch is printed, not raised
OPT_IN_PROBE = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from glava_tpu_torch.ops import lookup, smooth
rng = np.random.default_rng(6)
N, T, P = 1920, 1080, 1080
for card in range(torch.cuda.device_count()):
    dev = f"cuda:{card}"
    tabs = tuple(torch.as_tensor(rng.standard_normal((T, N)).astype(np.float32),
                                 device=dev).T for _ in range(4))
    idx = torch.as_tensor(rng.integers(0, T, (P, N)).astype(np.int32),
                          device=dev).T
    x = torch.as_tensor(rng.uniform(-1, 1, (2, 4096)).astype(np.float32),
                        device=dev)
    for name, run, plain in (
            ("rowwise_lookup C 4", lambda: lookup.rowwise_lookup(tabs, idx),
             lambda: lookup.rowwise_lookup_plain(tabs, idx)),
            ("smooth_scan sz 4096", lambda: (smooth.smooth_transform(x, 4.0, 0.01),),
             lambda: (smooth.smooth_transform_plain(x, 4.0, 0.01),))):
        try:
            got = run()
            torch.cuda.synchronize(card)
            err = max((a - b).abs().max().item() for a, b in zip(got, plain()))
            print(f"{dev} {name}: launched, max abs err against plain {err:.2e}")
        except RuntimeError as e:
            print(f"{dev} {name}: {e}")
'''


def _eager_scaling_table(devices, n_devices: int, per_device: int = 64,
                         updates: int = 8) -> dict:
    """``entry_points._scaling_table``'s weak-scaling reading with each
    shard's eager ``AudioPipeline.advance`` in place of its compiled
    update: windows/s on one device against ``n_devices``."""
    from glava_tpu_torch.config import loader
    from glava_tpu_torch.entry_points import BARS_512, _host_batch
    from glava_tpu_torch.parallel.batch import ShardedRenderer
    from glava_tpu_torch.parallel.mesh import make_mesh

    lc = loader.load(cli_requests=BARS_512, force_module="bars")
    out = {}
    for ndev in dict.fromkeys((1, n_devices)):
        S = per_device * ndev
        sr = ShardedRenderer([lc], [0] * S, make_mesh(devices[:ndev], rows=1))
        audio = _host_batch(S, lc.cfg)["audio"]
        runs = []
        for sh, (sl, _) in zip(sr.shards, sr.blocks):
            pipe = sh.renderer.pipeline
            a = torch.as_tensor(audio[sl], device=sh.device)
            g = torch.full((sl.stop - sl.start,), np.float32(
                lc.cfg.gravity_step / lc.cfg.nominal_ups), device=sh.device)
            runs.append([pipe, pipe.init_state(batch=(a.shape[0],)),
                         [a * (1.0 + 1e-3 * k) for k in range(updates)], g])

        def step(i, runs=runs):
            for run in runs:
                pipe, chains, feeds, g = run
                run[1] = pipe.advance(chains, feeds[i][:, 0], feeds[i][:, 1],
                                      gravity_g=g)

        ms = host_ms(step, updates, devices[:ndev])
        out[f"{ndev}dev"] = {"streams": S, "windows_per_s": S / (ms / 1e3)}
    out["weak_scaling_efficiency"] = (
        out[f"{n_devices}dev"]["windows_per_s"]
        / (out["1dev"]["windows_per_s"] * n_devices))
    return out


def compiled_run(parent: str | None = None) -> int:
    """``--compiled [PARENT]``: the device phase, the build,
    ``phase_compiled`` and ``_compiled_times``; with PARENT, the bench
    line and ``bench.windows_spread()`` of PARENT (eager) and of this
    tree (compiled), each tree in processes of its own, parent, this,
    this, parent."""
    card = phase_device()
    phase_build()
    phase_while(card)
    with tempfile.TemporaryDirectory() as td:
        user_dir = str(write_shader_modules(Path(td)))
        for line in phase_compiled(user_dir, Path(td)):
            print(f"[4 compiled] {line}")
        _compiled_times(card, user_dir)
    if parent is not None:
        tree = Path(parent).resolve()
        code = ("import json, sys; from glava_tpu_torch import bench; "
                "print(json.dumps(bench.run())); "
                "print(json.dumps(bench.windows_spread()))")
        for label, cwd in (("parent", tree), ("this", ROOT), ("this", ROOT),
                           ("parent", tree)):
            out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                raise AssertionError(f"the bench of {cwd} failed:\n"
                                     f"{out.stderr[-4000:]}")
            line, spread = out.stdout.strip().splitlines()[-2:]
            print(f"[5 bench] {label} ({cwd.name}) line ({card}): {line}")
            print(f"[5 bench] {label} ({cwd.name}) windows_spread ({card}): "
                  f"{spread}")
    print("[4 compiled] every check passed")
    return 0


def sharded(parent: str | None = None) -> int:
    """``--sharded [PARENT]``: the device phase, the build, with PARENT
    (another tree, for example the parent commit unpacked by ``git
    archive``) its per-device kernels on every card (``OPT_IN_PROBE``),
    then this tree's sharded fleets and per-card kernels
    (``phase_sharded``), ``dryrun_multichip(4)`` over the visible cards
    and the sharded fleets' frame times: what a machine of several
    cards adds."""
    card = phase_device()
    phase_build()
    if parent is not None:
        tree = Path(parent).resolve()
        out = subprocess.run([sys.executable, "-c", OPT_IN_PROBE, str(tree)],
                             cwd=tree, capture_output=True, text=True,
                             timeout=600)
        for line in out.stdout.splitlines():
            print(f"[4 sharded] {tree.name}: {line}")
        if out.returncode != 0:
            raise AssertionError(f"the probe of {tree} failed:\n{out.stderr}")
    with tempfile.TemporaryDirectory() as td:
        user_dir = str(write_shader_modules(Path(td)))
        for line in phase_sharded(user_dir):
            print(f"[4 sharded] {line}")
        _dryrun(None, "[4 sharded]")
        from glava_tpu_torch.entry_points import _devices, _scaling_table

        devices = _devices(4, None)
        for _ in range(2):
            print(f"[5 times] weak scaling, eager update ({card}): "
                  f"{json.dumps(_eager_scaling_table(devices, 4))}")
            print(f"[5 times] weak scaling, compiled update ({card}): "
                  f"{json.dumps(_scaling_table(devices, 4))}")
        _sharded_fleet_times(card, user_dir)
        _circle_mesh_times(card, user_dir)
    print("[4 sharded] every check passed")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded"] and len(sys.argv) <= 3:
        raise SystemExit(sharded(*sys.argv[2:]))
    if sys.argv[1:2] == ["--compiled"] and len(sys.argv) <= 3:
        raise SystemExit(compiled_run(*sys.argv[2:]))
    if sys.argv[1:2] == ["--fused-ab"]:
        raise SystemExit(fused_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--smooth-ab"]:
        raise SystemExit(smooth_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--while-ab"]:
        raise SystemExit(while_ab(sys.argv[2:]))
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        raise SystemExit(ab(sys.argv[2]))
    raise SystemExit(main())
