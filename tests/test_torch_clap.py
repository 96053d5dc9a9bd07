"""The port's CLAP (`adt_str_tpu_torch/clap/`) against the JAX package's, on the CPU.

Both packages get the same weights: a seeded state dict in HF `ClapModel`'s
key layout (`clap.model.random_state_dict`, drawn with numpy), loaded into
JAX with `audio_params_from_torch_state_dict` /
`text_params_from_torch_state_dict` and into the port with
`load_state_dict`. The small configuration is `tests/test_clap.py`'s
(window 4, 16 mels, spec 64, hidden 16, depths 2 2, heads 2 4, fusion on;
text vocab 120, hidden 32, 2 layers); the wrapper tests use the real input
geometry (64 mels, spec 256) with the same small widths, as
`tests/test_curation_sharded.py` does.

- K1 at CLAP's frontend: the plain K1 (what the kernel wrapper runs for a
  CPU tensor) against `pallas_log_mel(..., trim=False, interpret=True)`;
- the feature extractor: the host path bit-equal to JAX's, the same crops
  from the same seed; `device_log_mel_db` against JAX's (XLA on the CPU);
- the towers at fp32 within 1e-5, the fused local path taken and not;
- the wrapper, the weights carried across, `from_dir`, the mesh path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adt_str_tpu.clap import audio_model as jaudio
from adt_str_tpu.clap import features as jfeat
from adt_str_tpu.clap import model as jmodel
from adt_str_tpu.clap import text_model as jtext
from adt_str_tpu.ops.pallas_mel import pallas_log_mel
from adt_str_tpu_torch.clap import features as tfeat
from adt_str_tpu_torch.clap import model as tmodel
from adt_str_tpu_torch.clap.audio_model import ClapAudioArch, ClapAudioTower
from adt_str_tpu_torch.clap.convert import state_dict_from_jax_clap_params
from adt_str_tpu_torch.clap.text_model import ClapTextArch, ClapTextTower, get_text_features
from adt_str_tpu_torch.ops import cuda_mel
from adt_str_tpu_torch.parallel.mesh import make_mesh

SMALL_AUDIO = dict(window_size=4, num_mel_bins=16, spec_size=64, patch_size=4, patch_stride=4, hidden_size=16,
                   projection_dim=32, depths=(2, 2), num_heads=(2, 4), patch_embeds_hidden_size=8,
                   enable_fusion=True, aff_block_r=4)
REAL_INPUT_AUDIO = {**SMALL_AUDIO, "num_mel_bins": 64, "spec_size": 256}
SMALL_TEXT = dict(vocab_size=120, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                  max_positions=48, projection_dim=32)
TOL = 1e-5  # fp32 on both sides, other summation orders


def archs(audio_kw):
    return ((ClapAudioArch(**audio_kw), ClapTextArch(**SMALL_TEXT)),
            (jaudio.ClapAudioArch(**audio_kw), jtext.ClapTextArch(**SMALL_TEXT)))


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def small():
    (ta, tt), (ja, jt) = archs(SMALL_AUDIO)
    sd = tmodel.random_state_dict(ta, tt, seed=0)
    audio, text = ClapAudioTower(ta), ClapTextTower(tt)
    for tower in (audio, text):
        tmodel.load_tower(tower, sd)
        tower.eval()
    return {"sd": sd, "audio": audio, "text": text, "ja": ja, "jt": jt,
            "japarams": jaudio.audio_params_from_torch_state_dict(numpy_sd(sd), ja),
            "jtparams": jtext.text_params_from_torch_state_dict(numpy_sd(sd), jt)}


@pytest.fixture(scope="module")
def wrappers():
    """The port's and the JAX package's wrappers on one seeded state dict,
    at the real input geometry, on the CPU."""
    (ta, tt), (ja, jt) = archs(REAL_INPUT_AUDIO)
    sd = tmodel.random_state_dict(ta, tt, seed=1)
    port = tmodel.ClapWrapper("unused", state_dict=sd, audio_arch=ta, text_arch=tt, device="cpu")
    ref = jmodel.ClapWrapper("unused", state_dict=numpy_sd(sd), audio_arch=ja, text_arch=jt)
    return port, ref, sd


def same_crops(monkeypatch, *wrappers):
    """Give each wrapper's extractor a fresh generator of one seed: the long
    clips' crops then come out the same."""
    for w in wrappers:
        monkeypatch.setattr(w.feature_extractor, "rng", np.random.default_rng(0))


def clips(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * 0.3).astype(np.float32) for n in lengths]


# ------------------------------------------------------------ K1 at CLAP's frontend

@pytest.mark.parametrize("seconds", [1, 10])
def test_clap_frontend_plain_k1_matches_pallas_interpret(seconds):
    """(2, T) at 48 kHz, n_fft 1024, hop 480, 64 mels to 14 kHz, dB, no
    trim. The 10 s rows are a repeat-padded one-shot with a silent tail
    (frames at the 1e-10 floor) and noise; 1001 frames is 7 tiles of 128
    and one of 105. Same bf16 frames and bases, fp32 accumulation in another
    order: 1e-3 dB."""
    rng = np.random.default_rng(seconds)
    n = seconds * tfeat.SAMPLE_RATE
    if seconds == 10:
        one_shot = tfeat.ClapFeatureExtractor()._pad_short(rng.normal(size=13_001) * 0.4)
        wave = np.stack([one_shot, rng.normal(size=n) * 0.3]).astype(np.float32)
    else:
        wave = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
    ref = np.asarray(pallas_log_mel(jnp.asarray(wave), jfeat._clap_mel_params(), trim=False, interpret=True))
    out = cuda_mel.log_mel_plain(torch.from_numpy(wave), tfeat._clap_mel_params(), trim=False).numpy()
    assert out.shape == ref.shape == (2, 1 + n // tfeat.HOP, tfeat.N_MELS)
    if seconds == 10:
        assert out[0].min() < -99.99  # the silent tail sits at the floor, 10 log10(1e-10)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_clap_frontend_fits_the_kernel():
    """The kernel's checks and its grid at the CLAP batch: hop % 8, n_fft %
    64, a 3-tile table (bins to 14 kHz), 32 x 8 frame tiles: no split."""
    params = tfeat._clap_mel_params()
    assert params.hop_length % 8 == 0 and params.n_fft % 64 == 0
    table = cuda_mel.mel_table(params)
    n_tiles = table.shape[0] // cuda_mel.FREQ_TILE
    assert n_tiles == 3
    frame_tiles = -(-params.n_frames(tfeat.MAX_SAMPLES) // cuda_mel.TILE_FRAMES)
    assert frame_tiles == 8 and cuda_mel.freq_split(32 * frame_tiles, n_tiles, 132) == 1


# ----------------------------------------------------------------- features

@pytest.mark.parametrize("lengths", [[3 * 48_000], [14 * 48_000, 2 * 48_000], [13_001, 91_193, 7919, 0]],
                         ids=["short", "long", "ragged"])
def test_host_extractor_bit_equal_to_jax(lengths):
    audios = clips(len(lengths), lengths)
    ours, ours_longer = tfeat.ClapFeatureExtractor(rng=np.random.default_rng(7))(audios)
    theirs, their_longer = jfeat.ClapFeatureExtractor(rng=np.random.default_rng(7))(audios)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours_longer, their_longer)


def test_hf_longer_quirk_draws_like_jax():
    audios = clips(3, [20_000, 30_000, 40_000])
    ours = tfeat.ClapFeatureExtractor(rng=np.random.default_rng(4), replicate_hf_longer_quirk=True)(audios)
    theirs = jfeat.ClapFeatureExtractor(rng=np.random.default_rng(4), replicate_hf_longer_quirk=True)(audios)
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[1].sum() == 1


def test_device_log_mel_db_matches_jax():
    """`device_log_mel_db` (K1; on a CPU tensor its plain version) against the
    JAX package's device path, on repeat-padded one-shots: as that path runs
    on an accelerator (the Pallas kernel, interpret mode) within 1e-3 dB, and
    as it runs on the CPU (XLA, fp32 frames). K1 rounds the frames to bf16,
    as the Pallas kernel does, so against fp32 frames each band's power moves
    by at most bf16's unit roundoff (2^-9) times its frame's total mel power:
    a band 56 dB under its frame's loudest moves by up to 2 dB, and no dB
    bound holds there (`tests/test_clap.py`'s 5e-2 dB compares two fp32
    paths)."""
    fx = tfeat.ClapFeatureExtractor()
    waves = np.stack([fx._pad_short(a) for a in clips(5, [13_001, 91_193])]).astype(np.float32)
    ours = tfeat.device_log_mel_db(torch.from_numpy(waves)).numpy()
    pallas = np.asarray(pallas_log_mel(jnp.asarray(waves), jfeat._clap_mel_params(), trim=False, interpret=True))
    xla = jfeat.device_log_mel_db(waves)
    assert ours.shape == pallas.shape == xla.shape == (2, 1001, 64)
    np.testing.assert_allclose(ours, pallas, atol=1e-3, rtol=0)
    power, xla_power = 10.0 ** (ours.astype(np.float64) / 10), 10.0 ** (xla.astype(np.float64) / 10)
    frame_power = xla_power.sum(axis=-1, keepdims=True)
    assert (np.abs(power - xla_power) <= 2.0**-9 * frame_power).all()


# ------------------------------------------------------------------- towers

@pytest.mark.parametrize("is_longer", [[False, False], [False, True], [True, True]], ids=["short", "mixed", "long"])
def test_audio_tower_matches_jax(small, is_longer):
    """Pooled (B, hidden) and projected (B, projection_dim) outputs at T =
    251 (the bicubic interpolation path), with and without the fused local
    path."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 4, 251, 16)).astype(np.float32)
    longer = np.asarray(is_longer)
    with torch.no_grad():
        pooled = small["audio"].pooled(torch.from_numpy(feats), torch.from_numpy(longer)).numpy()
        emb = small["audio"](torch.from_numpy(feats), torch.from_numpy(longer)).numpy()
    jp = small["japarams"]
    ref_pooled = np.asarray(jaudio.audio_encoder_forward(jp["audio_model"], jnp.asarray(feats), jnp.asarray(longer),
                                                         small["ja"]))
    ref_emb = np.asarray(jaudio.get_audio_features(jp, jnp.asarray(feats), jnp.asarray(longer), small["ja"]))
    assert pooled.shape == (2, 16) and emb.shape == (2, 32)
    np.testing.assert_allclose(pooled, ref_pooled, atol=TOL, rtol=0)
    np.testing.assert_allclose(emb, ref_emb, atol=TOL, rtol=0)


def test_text_tower_matches_jax(small):
    """Padded id rows of unequal lengths (RoBERTa's padding-offset
    positions, the finfo.min key mask)."""
    rng = np.random.default_rng(1)
    ids = rng.integers(4, 100, (3, 12)).astype(np.int64)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    ids[1, 5:], mask[1, 5:] = 1, 0
    ids[2, 9:], mask[2, 9:] = 1, 0
    ours = get_text_features(small["text"], torch.from_numpy(ids), torch.from_numpy(mask).float()).numpy()
    ref = np.asarray(jtext.get_text_features(small["jtparams"], jnp.asarray(ids), jnp.asarray(mask, jnp.float32),
                                             small["jt"]))
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    no_mask = get_text_features(small["text"], torch.from_numpy(ids)).numpy()  # the mask from the pad id
    np.testing.assert_allclose(no_mask, ours, atol=1e-6, rtol=0)


def test_state_dict_keys_are_hf_clap_models():
    """The towers' keys and shapes are HF `ClapModel`'s (with its buffers),
    so an HF checkpoint loads with `load_state_dict`."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.clap.configuration_clap import ClapConfig

    a = {**SMALL_AUDIO, "patch_stride": [4, 4], "num_attention_heads": [2, 4], "depths": [2, 2]}
    a.pop("num_heads")
    t = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
             max_position_embeddings=48, projection_dim=32)
    cfg = ClapConfig(text_config=t, audio_config=a, projection_dim=32)
    hf = {k: tuple(v.shape) for k, v in transformers.ClapModel(cfg).state_dict().items()}
    (ta, tt), _ = archs(SMALL_AUDIO)
    ours = {k: tuple(v.shape) for tower in (ClapAudioTower(ta), ClapTextTower(tt))
            for k, v in tower.state_dict().items()}
    assert {k: v for k, v in hf.items() if not k.startswith("logit_scale")} == ours


# ------------------------------------------------------------------ wrapper

@pytest.mark.parametrize("lengths", [[13_001, 91_193, 7919], [12 * 48_000, 30_000]], ids=["short", "long"])
def test_wrapper_matches_jax_wrapper(wrappers, lengths, monkeypatch):
    port, ref, _ = wrappers
    same_crops(monkeypatch, port, ref)
    audios = clips(11, lengths)
    ours = port.get_audio_features(audios)
    theirs = ref.get_audio_features(audios)
    assert ours.shape == (len(lengths), 32)
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)


def test_semantic_match_matches_jax(wrappers):
    """softmax(logit_scale_a * audio @ text^T), each side on its own
    embeddings of the same clips and token ids."""
    port, ref, _ = wrappers
    audios = clips(12, [20_000, 40_000])
    ids = np.random.default_rng(3).integers(4, 100, (3, 10)).astype(np.int64)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    ids[2, 6:], mask[2, 6:] = 1, 0
    ours_text = get_text_features(port.text, torch.from_numpy(ids), torch.from_numpy(mask).float()).numpy()
    their_text = np.asarray(jtext.get_text_features(ref.text_params, jnp.asarray(ids), jnp.asarray(mask, jnp.float32),
                                                    ref.text_arch))
    ours = port.semantic_match(port.get_audio_features(audios), ours_text)
    theirs = ref.semantic_match(ref.get_audio_features(audios), their_text)
    assert port.logit_scale_a == pytest.approx(ref.logit_scale_a, rel=1e-7)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(ours, theirs, atol=TOL, rtol=0)


def test_device_resident_path_equals_the_host_route(wrappers, monkeypatch):
    """The short-clip device path (one wave upload, K1, the 4x view, the
    tower) against the route spelled out: the extractor's padding, the
    device mel stacked 4x on the host, `is_longer` False, the tower, as
    `tests/test_clap.py` holds the JAX wrapper's; forced on here (a CPU
    tensor runs K1's plain version)."""
    port, _, _ = wrappers
    monkeypatch.setattr(port, "device_mel", True)
    audios = clips(13, [30_000, 7919])
    fused = port.get_audio_features(audios)
    padded = np.stack([port.feature_extractor._pad_short(a) for a in audios]).astype(np.float32)
    mel = tfeat.device_log_mel_db(torch.from_numpy(padded)).numpy()
    feats = np.repeat(mel[:, None], 4, axis=1)
    with torch.no_grad():
        routed = port.audio(torch.from_numpy(feats), torch.zeros(len(audios), dtype=torch.bool)).numpy()
    np.testing.assert_allclose(fused, routed, atol=1e-6, rtol=0)


def test_audio_tower_runs_without_tf32_and_restores_the_callers_settings(wrappers, monkeypatch):
    """The tower's products are true fp32 (matmul precision "highest",
    cuDNN's TF32 off) on both routes, and the caller's settings come back."""
    port, _, _ = wrappers
    seen = []
    forward = port.audio.forward

    def spy(*args):
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
        return forward(*args)

    prev = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        monkeypatch.setattr(port.audio, "forward", spy)
        audios = clips(17, [20_000])
        port.get_audio_features(audios)
        monkeypatch.setattr(port, "device_mel", True)
        port.get_audio_features(audios)
        assert seen == [("highest", False)] * 2
        assert (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32) == ("high", True)
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]


def test_weights_carried_across_from_jax_params(wrappers, monkeypatch):
    """JAX params -> `state_dict_from_jax_clap_params` -> the port gives the
    JAX wrapper's outputs, and the round trip gives back the state dict
    exactly."""
    port, ref, sd = wrappers
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    back = state_dict_from_jax_clap_params(to_np(ref.audio_params), to_np(ref.text_params), sd["logit_scale_a"].numpy())
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    carried = tmodel.ClapWrapper("unused", state_dict=back, audio_arch=port.audio_arch, text_arch=port.text_arch,
                                 device="cpu")
    same_crops(monkeypatch, carried, ref)
    audios = clips(14, [15_000, 11 * 48_000])
    np.testing.assert_allclose(carried.get_audio_features(audios), ref.get_audio_features(audios), atol=TOL, rtol=0)


def test_from_dir_equals_the_state_dict_wrapper(wrappers, tmp_path):
    """A checkpoint written by the port (`config.json` + `model.safetensors`
    through its own writer) loads in the port with the same tower shapes and
    weights, and in the JAX package through the safetensors package."""
    port, _, sd = wrappers
    tmodel.save_checkpoint(tmp_path, sd, port.audio_arch, port.text_arch)
    loaded = tmodel.ClapWrapper.from_dir(tmp_path, device="cpu")
    assert loaded.audio_arch == port.audio_arch and loaded.text_arch == port.text_arch
    audios = clips(15, [25_000, 60_000])
    np.testing.assert_array_equal(loaded.get_audio_features(audios), port.get_audio_features(audios))
    theirs = jmodel.ClapWrapper.from_dir(tmp_path)
    np.testing.assert_allclose(theirs.get_audio_features(audios), port.get_audio_features(audios), atol=TOL, rtol=0)


@pytest.mark.parametrize("device_resident", [False, True], ids=["host", "device-mel"])
def test_mesh_of_two_cpu_entries_equals_one_device(wrappers, monkeypatch, device_resident):
    """5 rows over two entries: padded to 6, 3 rows an entry, sliced back;
    an equal mesh made anew reuses the replicas."""
    port, _, _ = wrappers
    if device_resident:
        monkeypatch.setattr(port, "device_mel", True)
    audios = clips(16, [9000, 20_000, 31_000, 7919, 15_000])
    single = port.get_audio_features(audios)
    mesh = make_mesh(devices=["cpu", "cpu"])
    sharded = port.get_audio_features(audios, mesh=mesh)
    assert sharded.shape == single.shape == (5, 32)
    np.testing.assert_allclose(sharded, single, atol=1e-6, rtol=0)
    cached = port._mesh_towers
    port.get_audio_features(audios[:2], mesh=make_mesh(devices=["cpu", "cpu"]))
    assert port._mesh_towers is cached


def test_wrapper_needs_a_device_without_cuda(wrappers, monkeypatch):
    _, _, sd = wrappers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tmodel.ClapWrapper("unused", state_dict=sd, audio_arch=ClapAudioArch(**REAL_INPUT_AUDIO),
                           text_arch=ClapTextArch(**SMALL_TEXT))


def test_a_checkpoint_missing_weights_raises(wrappers):
    port, _, sd = wrappers
    partial = {k: v for k, v in sd.items() if "patch_embed.proj" not in k}
    with pytest.raises(KeyError, match="patch_embed.proj"):
        tmodel.ClapWrapper("unused", state_dict=partial, audio_arch=port.audio_arch, text_arch=port.text_arch,
                           device="cpu")
