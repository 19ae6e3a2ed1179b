"""A model family is found by its configuration's ``model_type``, from a
file of its own (``bench/families``): the decoder family's counts, weights
and reference against the values recorded before they moved there, a new
family from new files alone, and a ``model_type`` with no file refused."""

import hashlib
import json

import pytest
import torch

from bench.cost import Work, matmul
from bench.cost import model as W
from bench.harness import serve, traffic as TR, weights
from bench.reference import shared as RS, train as RT
from bench.spec import load_cell, model_spec
from bench.tests.tiny import BENCH, DENSE, MOE, OPT, TRAFFIC, make_root

CPU = torch.device("cpu")

# every count of ``bench/cost/model.py`` at the benchmark's configurations,
# (bytes, flops, bound_s) for a ``Work``: the values the counts gave before
# they moved into ``bench/families/decoder.py`` (the serve prefill lengths
# 1024, 2333, 4032, decode steps of 1 and 128 rows, both train traffics)
COUNTS = {
    'phi3.5-moe-1L': {
        ('layer_forward', (1,)):
            (2600786976, 398589952, 0.0007763543211940299),
        ('layer_forward', (128,)):
            (2624589824, 51019513856, 0.0007834596489552239),
        ('layer_forward', (2333,)):
            (3037859744, 929910358016, 0.0010425832593344703),
        ('layer_forward', (8192,)):
            (4135976960, 3265248886784, 0.0033206303043134175),
        ('layer_forward', (32768,)):
            (8742109184, 13060995547136, 0.013282403839343223),
        ('head', (1,)): (525481216, 262668288, 0.00015686006447761193),
        ('head', (128,)): (543850496, 33621540864, 0.0005018140427462686),
        ('head', (8192,)): (1710227456, 2151778615296, 0.03211609873576119),
        ('train_matmul', (2, 4096, 1)):
            (17538613248, 16251082506240, 0.10631018712022383),
        ('train_matmul', (32, 2048, 2)):
            (84042055680, 130008660049920, 0.850480792694328),
        ('train_flash', (2, 4096, 1)):
            (504365056, 962307555328, 0.0009730106727280081),
        ('train_flash', (32, 2048, 2)):
            (4034920448, 3850169745408, 0.0038929926647199194),
        ('active_layer_params', ()): 199294976,
        ('attention_flops', (1024, 1024)): 8598323200,
        ('attention_flops', (1, 4032)): 66060288,
        ('attention_flops', (4096, 4096)): 137472507904,
        ('train_model_flops', (2, 4096)): 17075917553664,
        ('train_model_flops', (32, 2048)): 133308805545984,
        ('prefill_matmul', (1024,)):
            (3318002944, 408418779136, 0.001035986363672034),
        ('prefill_matmul', (2333,)):
            (3563340960, 930173026304, 0.0011994433238120823),
        ('prefill_matmul', (4032,)):
            (3881774336, 1607377354752, 0.0017912526610385886),
        ('prefill_flash', (1024,)):
            (20971520, 8598323200, 8.6939567239636e-06),
        ('prefill_flash', (2333,)):
            (47779840, 44607258624, 4.510339597977755e-05),
        ('prefill_flash', (4032,)):
            (82575360, 133210570752, 0.00013469218478463093),
        ('prefill_model_flops', (1024,)): 417017102336,
        ('prefill_model_flops', (2333,)): 974780284928,
        ('prefill_model_flops', (4032,)): 1740587925504,
        ('decode_matmul', (1,)):
            (3126268192, 661258240, 0.0009332143856716418),
        ('decode_matmul', (128,)):
            (3168440320, 84641054720, 0.0012852736917014925),
        ('decode_model_flops', ((1023, 2332, 4095),)): 2105884672.0,
    },
    'phi3.5-moe-8L': {
        ('layer_forward', (1,)):
            (2600786976, 398589952, 0.0007763543211940299),
        ('layer_forward', (128,)):
            (2624589824, 51019513856, 0.0007834596489552239),
        ('layer_forward', (2333,)):
            (3037859744, 929910358016, 0.0010425832593344703),
        ('layer_forward', (8192,)):
            (4135976960, 3265248886784, 0.0033206303043134175),
        ('layer_forward', (32768,)):
            (8742109184, 13060995547136, 0.013282403839343223),
        ('head', (1,)): (525481216, 262668288, 0.00015686006447761193),
        ('head', (128,)): (543850496, 33621540864, 0.0005018140427462686),
        ('head', (8192,)): (1710227456, 2151778615296, 0.03211609873576119),
        ('train_matmul', (2, 4096, 1)):
            (104394129408, 84821309128704, 0.1760434235108056),
        ('train_matmul', (32, 2048, 2)):
            (451210641408, 678570473029632, 1.4083417539467433),
        ('train_flash', (2, 4096, 1)):
            (4034920448, 7698460442624, 0.007784085381824065),
        ('train_flash', (32, 2048, 2)):
            (32279363584, 30801357963264, 0.031143941317759355),
        ('active_layer_params', ()): 199294976,
        ('attention_flops', (1024, 1024)): 68786585600,
        ('attention_flops', (1, 4032)): 528482304,
        ('attention_flops', (4096, 4096)): 1099780063232,
        ('train_model_flops', (2, 4096)): 91419989508096,
        ('train_model_flops', (32, 2048)): 704971636998144,
        ('prefill_matmul', (1024,)):
            (22865655040, 3265511555072, 0.007189870458032988),
        ('prefill_matmul', (2333,)):
            (24828359168, 7439545532416, 0.008497526139153375),
        ('prefill_matmul', (4032,)):
            (27375826176, 12857180160000, 0.013232000836965425),
        ('prefill_flash', (1024,)):
            (167772160, 68786585600, 6.95516537917088e-05),
        ('prefill_flash', (2333,)):
            (382238720, 356858068992, 0.0003608271678382204),
        ('prefill_flash', (4032,)):
            (660602880, 1065684566016, 0.0010775374782770475),
        ('prefill_model_flops', (1024,)): 3334298140672,
        ('prefill_model_flops', (2333,)): 7796403601408,
        ('prefill_model_flops', (4032,)): 13922864726016,
        ('decode_matmul', (1,)):
            (21331777024, 3451387904, 0.0063676946340298505),
        ('decode_matmul', (128,)):
            (21540569088, 441777651712, 0.00676949123438806),
        ('decode_model_flops', ((1023, 2332, 4095),)): 11331043328.0,
    },
    'smollm-135m': {
        ('layer_forward', (1,)): (7098240, 7077888, 2.1188776119402984e-06),
        ('layer_forward', (128,)): (9682944, 905969664, 2.890431044776119e-06),
        ('layer_forward', (2333,)):
            (54559104, 16512712704, 1.8398969752893773e-05),
        ('layer_forward', (8192,)):
            (173801472, 57982058496, 6.327888251941505e-05),
        ('layer_forward', (32768,)):
            (673972224, 231928233984, 0.00025153092828661546),
        ('head', (1,)): (113445120, 56623104, 3.386421492537313e-05),
        ('head', (128,)): (138706944, 7247757312, 0.00010817548226865672),
        ('head', (8192,)): (1742733312, 463856467968, 0.00692323086519403),
        ('train_matmul', (2, 4096, 1)):
            (20870332416, 6609954668544, 0.026464792022329445),
        ('train_matmul', (32, 2048, 2)):
            (161102168064, 52879637348352, 0.2114331078562475),
        ('train_flash', (2, 4096, 1)):
            (2273771520, 4059734999040, 0.0041048887755712835),
        ('train_flash', (32, 2048, 2)):
            (18190172160, 16242903613440, 0.016423562804287157),
        ('active_layer_params', ()): 3538944,
        ('attention_flops', (1024, 1024)): 36274176000,
        ('attention_flops', (1, 4032)): 278691840,
        ('attention_flops', (4096, 4096)): 579962142720,
        ('train_model_flops', (2, 4096)): 10089727524864,
        ('train_model_flops', (32, 2048)): 66802126159872,
        ('prefill_matmul', (1024,)):
            (950995200, 217489342464, 0.00028502529004482133),
        ('prefill_matmul', (2333,)):
            (1750218240, 495438004224, 0.0005858333075121864),
        ('prefill_matmul', (4032,)):
            (2787559680, 856197955584, 0.0009762632705962606),
        ('prefill_flash', (1024,)):
            (94371840, 36274176000, 3.667762992922144e-05),
        ('prefill_flash', (2333,)):
            (215009280, 188186872320, 0.00019027995178968655),
        ('prefill_flash', (4032,)):
            (371589120, 561982095360, 0.0005682326545601618),
        ('prefill_model_flops', (1024,)): 253763518464,
        ('prefill_model_flops', (2333,)): 683624876544,
        ('prefill_model_flops', (4032,)): 1418180050944,
        ('decode_matmul', (1,)): (326392320, 268959744, 9.74305432835821e-05),
        ('decode_matmul', (128,)):
            (429195264, 34426847232, 0.0001948884136119403),
        ('decode_model_flops', ((1023, 2332, 4095),)): 1322030592.0,
    },
}

# the decoder family at the tiny sizes, as before the move: each seed's
# weights (sha256 of every parameter's bytes, in group and name order,
# first 16 digits), the reference's loss on the tiny train traffic's first
# batch in float32 and float8, and the sha256 of its logits at positions
# 9..15 of the batch's first row (positions 0..9 one capacity group) and of
# the serve check's candidates there (tiny-moe seed 0: a near tie at
# position 13 gives 3)
TINY = {
    ("tiny-moe", 0): ("d306247925e76a9c", 5.422823429107666,
                      5.400920391082764, "cbbda8dbed13925d",
                      "0c30ee0ef091ed43", [1, 1, 1, 1, 3, 1, 1]),
    ("tiny-moe", 1): ("90b5e0a241784be9", 5.324158668518066,
                      5.324420928955078, "e9dede94cc5dcdd6",
                      "e9dede94cc5dcdd6", [1] * 7),
    ("tiny-dense", 0): ("4b984b437b8918c1", 4.558954238891602,
                        4.553891658782959, "624e17f94ca8a8ff",
                        "624e17f94ca8a8ff", [1] * 7),
    ("tiny-dense", 1): ("3869c6f9d2175c53", 4.592191219329834,
                        4.591314315795898, "41642e765fc5dd78",
                        "41642e765fc5dd78", [1] * 7),
}


def _spec(name):
    return model_spec(json.loads((BENCH / "configs" / f"{name}.json")
                                 .read_text()))


def _value(v):
    return (v.bytes, v.flops, v.bound_s) if isinstance(v, Work) else v


@pytest.mark.parametrize("config,fn", sorted(
    {(c, f) for c, calls in COUNTS.items() for f, _ in calls}))
def test_the_counts_are_the_parents(config, fn):
    s = _spec(config)
    for (f, args), want in COUNTS[config].items():
        if f == fn:
            assert _value(getattr(W, fn)(s, *args)) == want, args


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("config,seed", sorted(TINY))
def test_the_weights_and_the_reference_are_the_parents(config, seed):
    cfg = {"tiny-moe": MOE, "tiny-dense": DENSE}[config]
    spec = model_spec(dict(cfg))
    ref = spec.family.reference
    wd, want_loss, want_loss8, want_logits, want_cands, n_cands = \
        TINY[config, seed]
    p = weights.make(spec, seed, CPU)
    assert _digest([t for g in sorted(p)
                    for _, t in sorted(p[g].items())]) == wd
    p = weights.make(spec, seed, CPU, torch.float32)
    batch = TR.train_batch(TRAFFIC["tiny-train"], spec.vocab, seed, 0, CPU)
    toks = batch["tokens"][:1]
    info = {"n": 10, "prompt": toks[0, :10].numpy(),
            "tokens": toks[0, 10:].tolist() + [0]}
    with torch.no_grad():
        assert float(ref.loss(p, batch, spec)) == want_loss
        assert float(ref.loss(p, batch, spec,
                              RS.Precision("float8"))) == want_loss8
        logits = ref.logits_at(p, toks, spec, list(range(9, 16)),
                               [(0, 10, True), (10, 16, False)])
        assert _digest([logits]) == want_logits
        seq, groups, rows = serve._sequence(info, CPU)
        cands = ref.candidates(p, seq, spec, rows, groups)
    assert _digest(cands) == want_cands
    assert [c.shape[0] for c in cands] == n_cands


@pytest.mark.parametrize("name", ["phi3.5-moe-1L", "phi3.5-moe-8L",
                                  "smollm-135m"])
def test_the_benchmarks_configurations_are_the_decoder_family(name):
    from bench.families import decoder
    s = _spec(name)
    assert s.model_type in ("llama", "phimoe")
    assert s.family.layout is decoder.layout
    assert s.family.reference is decoder and s.family.cost is decoder


TOY = """
import sys
from dataclasses import dataclass, field

import torch

from bench.cost import matmul

READ = {"hidden_size", "vocab_size", "num_hidden_layers"}


@dataclass(frozen=True)
class Spec:
    name: str
    model_type: str
    n_layers: int
    d_model: int
    vocab: int
    param_dtype: str
    compute_dtype: str
    logits_dtype: str
    norm_init_std: float
    tie_embeddings: bool = True
    embed_init_std: float = 0.02
    residual_init_scale: float = 1.0
    family: object = field(default=None, compare=False, repr=False)


def spec(cfg):
    r = cfg["run"]
    return Spec(cfg["name"], cfg["model_type"], cfg["num_hidden_layers"],
                cfg["hidden_size"], cfg["vocab_size"], r["param_dtype"],
                r["compute_dtype"], r["logits_dtype"], r["norm_init_std"])


def arch_config(spec):
    raise NotImplementedError("the program builds no toy")


def layout(spec):
    L, D, V = spec.n_layers, spec.d_model, spec.vocab
    return {"embed": {"tok": ((V, D), spec.embed_init_std)},
            "pos0": {"w": ((L, D, D), D ** -0.5)}}


def hidden(params, tokens, spec, prec=None):
    x = params["embed"]["tok"][tokens]
    for w in params["pos0"]["w"]:
        x = x + torch.tanh(x @ w)
    return x


def loss(params, batch, spec, prec=None):
    logits = hidden(params, batch["tokens"], spec) @ params["embed"]["tok"].T
    return torch.nn.functional.cross_entropy(logits.flatten(0, 1),
                                             batch["labels"].flatten())


def head(spec, rows):
    return matmul(rows, spec.d_model, spec.vocab, spec.logits_dtype)


reference = cost = sys.modules[__name__]
"""


def test_a_new_family_from_new_files_alone(tmp_path):
    """A family file, a configuration and a traffic mix added under a
    checkout's root, with entries in its ``BENCHMARK.json``, are found by
    ``load_cell``; the weights are drawn by the family's layout, the counts
    and the training reference reach its functions, and no file the
    benchmark had changes."""
    root = make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file() and "__pycache__" not in str(p)}
    (root / "bench/families/toy.py").write_text(TOY)
    cfg = {"name": "toy-1", "source": "test", "reduced": [],
           "model_type": "toy", "hidden_size": 16, "vocab_size": 40,
           "num_hidden_layers": 2,
           "run": {"param_dtype": "float32", "compute_dtype": "float32",
                   "logits_dtype": "float32", "norm_init_std": 0.1}}
    (root / "bench/configs/toy-1.json").write_text(json.dumps(cfg))
    tr = dict(TRAFFIC["tiny-train"], batch=2, seq=6, grad_accum=1)
    (root / "bench/traffic/toy-train.json").write_text(json.dumps(tr))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-1", "source": "test",
                             "file": "bench/configs/toy-1.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy-1",
                               "traffic": "toy-train", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("toy-cell", root)
    spec = cell.spec
    assert (spec.model_type, spec.n_layers, spec.d_model) == ("toy", 2, 16)
    p = weights.make(spec, 5, CPU)
    assert {g: {n: tuple(t.shape) for n, t in sub.items()}
            for g, sub in p.items()} == {"embed": {"tok": (40, 16)},
                                         "pos0": {"w": (2, 16, 16)}}
    assert torch.equal(weights.draw(spec, 5, "pos0", "w", CPU),
                       p["pos0"]["w"])
    assert W.head(spec, 3) == matmul(3, 16, 40, "float32")
    batches = [TR.train_batch(tr, spec.vocab, 5, i, CPU) for i in range(2)]
    out = RT.steps(weights.make(spec, 5, CPU), batches, spec, OPT, 1)
    assert len(out["loss"]) == 2 and out["change"]["pos0/w"] > 0
    for path, data in before.items():
        assert path.read_bytes() == data, path


@pytest.mark.parametrize("model_type", ["deepseek_v2", "no_such_family",
                                        "../spec"])
def test_a_model_type_with_no_family_file_is_refused(model_type):
    with pytest.raises(ValueError, match="not built") as e:
        model_spec(dict(MOE, model_type=model_type))
    assert f"bench/families/{model_type}.py" in str(e.value)


def test_a_configuration_without_a_model_type_is_refused():
    cfg = {k: v for k, v in MOE.items() if k != "model_type"}
    with pytest.raises(ValueError, match="not built"):
        model_spec(cfg)
