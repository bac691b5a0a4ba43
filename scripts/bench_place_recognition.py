"""Place-recognition precision/recall at Atlas scale (round-5 verdict
Missing #1 / next-step #5): hundreds of keyframes across SEVERAL visually
similar synthetic rooms — the false-positive regime loop closing and map
merging actually face — scored through the SHIPPED vocabulary artifact.

Protocol: each room renders two laps of the generator trajectory; lap-1
views of ALL rooms form the KeyFrameDatabase, lap-2 views are queries
(each has a true revisit: the lap-1 view of the same room at the nearest
lap angle). A candidate is CORRECT iff same room and within an angular
window of the query (overlapping viewpoint). Reports top-1 accuracy,
precision@3, recall@3, and the dense vs mesh-sharded query agreement +
timing at this K (SURVEY §5.8 sharded KFDB scoring).

Prints ONE JSON line. Usage:
  python scripts/bench_place_recognition.py [--per-lap 85] [--rooms 3]
      [--vocab assets/ORBvoc_synth.bin] [--half-res]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-lap", type=int, default=85,
                    help="views per lap per room (DB size = rooms*per_lap)")
    ap.add_argument("--rooms", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", default=[301, 302, 303, 304])
    ap.add_argument("--vocab", default=os.path.join(REPO, "assets", "ORBvoc_synth.bin"))
    ap.add_argument("--half-res", action="store_true",
                    help="render 376x240 (4x faster; fewer features)")
    args = ap.parse_args()

    import make_synth_euroc as gen
    from orbslam3_jax.atlas.kfdb import KeyFrameDB
    from orbslam3_jax.io import vocab_io
    from orbslam3_jax.ops import bow, features as feat
    from orbslam3_jax.parallel import kfdb_sharded

    voc = vocab_io.load_binary_vocabulary(args.vocab)
    orb = feat.OrbParams(n_features=1000, n_levels=8)
    wh = (376, 240) if args.half_res else (gen.W, gen.H)
    intr = (gen.FX / 2, gen.FY / 2, gen.CX / 2, gen.CY / 2) if args.half_res \
        else (gen.FX, gen.FY, gen.CX, gen.CY)

    n_lap = args.per_lap
    rooms = args.rooms
    db_n = rooms * n_lap

    def views(seed, lap):
        rng = np.random.default_rng(seed)
        tex = gen.make_textures(rng)
        out = []
        for i in range(n_lap):
            t = (i + (0.5 if lap else 0.0)) / n_lap * gen.T_LOOP
            R, p = gen.pose_at(t)
            img = gen.render(tex, R, p, wh=wh, intr=intr)
            f = feat.extract(jnp.asarray(img.astype(np.float32)), orb)
            out.append((f.desc, f.valid))
        return out

    t_render0 = time.perf_counter()
    db = KeyFrameDB(voc, Kmax=db_n)
    db_room = np.zeros(db_n, np.int32)
    db_angle = np.zeros(db_n, np.float32)
    k = 0
    queries = []  # (room, angle_idx, desc, valid)
    for r in range(rooms):
        for desc, valid in views(args.seeds[r], lap=0):
            db.add(k, desc, valid)
            db_room[k] = r
            db_angle[k] = (k % n_lap) / n_lap
            k += 1
        for i, (desc, valid) in enumerate(views(args.seeds[r], lap=1)):
            queries.append((r, (i + 0.5) / n_lap, desc, valid))
    t_build = time.perf_counter() - t_render0

    covis0 = jnp.zeros((db_n, db_n), jnp.int32)
    ang_win = 1.6 / n_lap  # ~1.6 view spacings: overlapping viewpoint

    def correct(qroom, qang, cid):
        if cid < 0:
            return False
        d = abs(db_angle[cid] - qang)
        d = min(d, 1.0 - d)  # circular lap
        return db_room[cid] == qroom and d <= ang_win

    top1 = prec_n = prec_d = rec = 0
    t_q = 0.0
    for qroom, qang, desc, valid in queries:
        t0 = time.perf_counter()
        ids, scores = db.query_frame(desc, valid, covis0, n_best=3)
        jax.block_until_ready(scores)
        t_q += time.perf_counter() - t0
        ids = np.asarray(ids)
        oks = [correct(qroom, qang, int(c)) for c in ids if c >= 0]
        top1 += bool(oks and oks[0])
        prec_n += sum(oks)
        prec_d += len(oks)
        rec += any(oks)
    nq = len(queries)

    # Sharded query at this K over the virtual 8-device mesh: timing +
    # top-1 agreement with the dense path.
    mesh = kfdb_sharded.make_mesh(jax.devices("cpu")[:8])
    agree = 0
    t_s = 0.0
    for qroom, qang, desc, valid in queries[:32]:
        words = bow.transform(voc, desc, valid)
        vec = bow.bow_vector(voc, words)
        t0 = time.perf_counter()
        sids, sscores = kfdb_sharded.sharded_query(
            vec, words, db.vecs, db.valid, mesh, n_best=3)
        jax.block_until_ready(sscores)
        t_s += time.perf_counter() - t0
        dids, _ = db.query_frame(desc, valid, covis0, n_best=3)
        s0 = int(np.asarray(sids)[0])
        agree += bool(s0 >= 0 and correct(qroom, qang, s0)
                      == correct(qroom, qang, int(np.asarray(dids)[0])))

    print(json.dumps({
        "db_keyframes": db_n, "rooms": rooms, "queries": nq,
        "vocab_words": int(voc.n_words),
        "vocab_file": os.path.basename(args.vocab),
        "top1_accuracy": round(top1 / nq, 3),
        "precision_at_3": round(prec_n / max(prec_d, 1), 3),
        "recall_at_3": round(rec / nq, 3),
        "dense_query_ms": round(t_q / nq * 1e3, 1),
        "sharded_query_ms": round(t_s / 32 * 1e3, 1),
        "sharded_top1_agreement": round(agree / 32, 3),
        "build_s": round(t_build, 1),
    }))


if __name__ == "__main__":
    main()
