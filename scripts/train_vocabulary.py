"""Train the shipped place-recognition vocabulary OFFLINE, on imagery
unrelated to any replayed sequence — the reference's vocabulary lifecycle
(`/root/reference/README.md:17-19`: a ~1M-word ORBvoc trained offline,
loaded from the fork's binary format at
`Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1442`).

Renders views from several generator worlds (texture seeds disjoint from
every dataset seed used by replays/tests), extracts ORB at the production
budget, trains the k-medians tree, and saves BOTH formats:

  assets/ORBvoc_synth.bin   — reference-binary (41-byte records), the
                              artifact `run_sequence.py` loads by default
  assets/ORBvoc_synth.npz   — native npz (fast load, same tree)

Usage: python scripts/train_vocabulary.py [--views 48] [--k 10] [--depth 4]
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

from orbslam3_jax.utils import enable_compile_cache

enable_compile_cache()

import numpy as np
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=48, help="views per world")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs="+", default=[101, 102, 103])
    ap.add_argument("--out", default=os.path.join(REPO, "assets", "ORBvoc_synth"))
    args = ap.parse_args()

    import make_synth_euroc as gen
    from orbslam3_jax.ops import bow, features as feat
    from orbslam3_jax.io import vocab_io

    orb = feat.OrbParams(n_features=1000, n_levels=8)
    train = []
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        tex = gen.make_textures(rng)
        # Poses spread over the lap + varied height/attitude via the
        # analytic trajectory at staggered times.
        for i in range(args.views):
            t = (i / args.views) * gen.T_LOOP
            R_wc, p = gen.pose_at(t)
            img = gen.render(tex, R_wc, p)
            f = feat.extract(jnp.asarray(img.astype(np.float32)), orb)
            train.append(np.asarray(f.desc)[np.asarray(f.valid)])
        print(f"world seed {seed}: {sum(len(d) for d in train)} descriptors total",
              flush=True)

    desc = np.concatenate(train)
    print(f"training k={args.k} depth={args.depth} on {len(desc)} descriptors",
          flush=True)
    voc = bow.build_vocabulary(desc, k=args.k, depth=args.depth, seed=0)
    print(f"vocabulary: {voc.n_words} words", flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    vocab_io.save_binary_vocabulary(args.out + ".bin", voc)
    bow.save_npz(args.out + ".npz", voc)
    # Round-trip sanity through the reference-binary path.
    voc2 = vocab_io.load_binary_vocabulary(args.out + ".bin")
    assert voc2.n_words == voc.n_words
    print(f"saved {args.out}.bin ({os.path.getsize(args.out + '.bin')} bytes) "
          f"and {args.out}.npz", flush=True)


if __name__ == "__main__":
    main()
