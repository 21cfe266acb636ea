"""Default config tree + kwargs adapters.

Mirrors the reference key schema (reference ``scripts/default_config.py:4-215``)
so that the reference's YAML files (e.g. ``configs/RGBNT_ieee_part_margin.yaml``)
load unmodified. Counterpart of ``ieee_tpu/config/defaults.py`` with the same
keys, except that the port's own knobs live under ``cfg.cuda`` in place of
``cfg.tpu``.
"""

from __future__ import annotations

from .node import ConfigNode


def get_default_config() -> ConfigNode:
    cfg = ConfigNode()

    # model
    cfg.model = ConfigNode()
    cfg.model.name = "resnet50"
    cfg.model.pretrained = True  # load pretrained backbone weights if available
    cfg.model.load_weights = ""  # path to model weights
    cfg.model.resume = ""  # path to checkpoint for resume training
    # IEEE ablation flags (reference attributes interaction/attention/using_REM,
    # ``ieee3modalPart.py:312-314``; README documents them as the ablation API)
    cfg.model.interaction = True
    cfg.model.attention = True
    cfg.model.using_REM = True

    # data
    cfg.data = ConfigNode()
    cfg.data.type = "image"
    cfg.data.root = "reid-data"
    cfg.data.sources = ["market1501"]
    cfg.data.targets = ["market1501"]
    cfg.data.workers = 1  # host decode threads
    # the JAX package's decode cache and device cache (False, True or a
    # directory path); not ported yet, the datamanager refuses them
    cfg.data.decode_cache = False
    cfg.data.device_cache = False
    cfg.data.split_id = 0
    cfg.data.height = 256
    cfg.data.width = 128
    cfg.data.combineall = False
    cfg.data.transforms = ["random_flip"]
    cfg.data.k_tfm = 1
    cfg.data.norm_mean = [0.485, 0.456, 0.406]
    cfg.data.norm_std = [0.229, 0.224, 0.225]
    cfg.data.save_dir = "log"
    cfg.data.load_train_targets = False

    # dataset-specific
    cfg.market1501 = ConfigNode()
    cfg.market1501.use_500k_distractors = False
    cfg.cuhk03 = ConfigNode()
    cfg.cuhk03.labeled_images = False
    cfg.cuhk03.classic_split = False
    cfg.cuhk03.use_metric_cuhk03 = False

    # sampler
    cfg.sampler = ConfigNode()
    cfg.sampler.train_sampler = "RandomSampler"
    cfg.sampler.train_sampler_t = "RandomSampler"
    cfg.sampler.num_instances = 4
    cfg.sampler.num_cams = 1
    cfg.sampler.num_datasets = 1

    # video
    cfg.video = ConfigNode()
    cfg.video.seq_len = 15
    cfg.video.sample_method = "evenly"
    cfg.video.pooling_method = "avg"

    # train
    cfg.train = ConfigNode()
    cfg.train.optim = "adam"
    cfg.train.lr = 0.0003
    cfg.train.weight_decay = 5e-4
    cfg.train.max_epoch = 60
    cfg.train.start_epoch = 0
    cfg.train.batch_size = 32
    cfg.train.fixbase_epoch = 0
    cfg.train.open_layers = ["classifier"]
    # The training knobs below carry the JAX package's meaning (see
    # ieee_tpu/config/defaults.py), so every config loads to the same values
    # in both packages: fixbase (fixbase_epoch, open_layers,
    # fixbase_bn_freeze, fixbase_bn_eval) and accum_steps are the engine's
    # (engine/engine.py)
    cfg.train.fixbase_bn_freeze = False
    cfg.train.fixbase_bn_eval = True
    cfg.train.staged_lr = False
    cfg.train.new_layers = ["classifier"]
    cfg.train.base_lr_mult = 0.1
    cfg.train.lr_scheduler = "single_step"
    cfg.train.stepsize = [20]
    cfg.train.gamma = 0.1
    cfg.train.print_freq = 20
    cfg.train.seed = 1
    cfg.train.accum_steps = 1

    # optimizers
    cfg.sgd = ConfigNode()
    cfg.sgd.momentum = 0.9
    cfg.sgd.dampening = 0.0
    cfg.sgd.nesterov = True
    cfg.rmsprop = ConfigNode()
    cfg.rmsprop.alpha = 0.99
    cfg.adam = ConfigNode()
    cfg.adam.beta1 = 0.9
    cfg.adam.beta2 = 0.999

    # loss
    cfg.loss = ConfigNode()
    cfg.loss.name = "softmax"
    cfg.loss.softmax = ConfigNode()
    cfg.loss.softmax.label_smooth = True
    cfg.loss.triplet = ConfigNode()
    cfg.loss.triplet_margin = 0.3
    cfg.loss.ieee_margin = 3
    cfg.loss.weight_c = 1.0
    cfg.loss.weight_t = 1.0
    cfg.loss.weight_m = 1.0
    cfg.loss.weight_x = 1.0
    cfg.loss.weight_m_warmup = 0
    cfg.loss.margin_mean_over_ids = False

    # test
    cfg.test = ConfigNode()
    cfg.test.batch_size = 100
    cfg.test.dist_metric = "euclidean"
    cfg.test.normalize_feature = False
    cfg.test.ranks = [1, 5, 10]
    cfg.test.evaluate = False
    cfg.test.eval_freq = -1
    cfg.test.start_eval = 0
    cfg.test.rerank = False
    cfg.test.visrank = False
    cfg.test.visrank_topk = 10

    # misc flags set by entry scripts (reference sets cfg.use_gpu at runtime)
    cfg.use_gpu = True

    # --- CUDA port additions (no reference analog) -------------------------
    # take the place of the JAX package's cfg.tpu section
    cfg.cuda = ConfigNode()
    cfg.cuda.compute_dtype = "bfloat16"  # conv/matmul dtype on the card
    # (params are always float32 masters, as in the JAX package)
    # 1x1 conv+BN sites that pass fuse_worthwhile run as the fused CUDA
    # kernels (models/common.py FusedConvBN1x1): mm_affine in eval, mm_stats,
    # mm_bn_da and mm_bn_dw in training. Off by default, as in the JAX
    # package (cfg.tpu.fused_1x1), until measured times say otherwise
    cfg.cuda.fused_1x1 = False
    # IEEE eval through the folded-BN head with the partpool CUDA kernel
    # (models/fast_eval.py). Off by default, as in the JAX package
    # (cfg.tpu.fused_eval), until measured times say otherwise
    cfg.cuda.fused_eval = False
    # the w8a8 post-training-quantized eval/serving path
    # (models/int8_eval.py): every trunk conv on the conv_s8 CUDA kernel,
    # activation scales calibrated on the first eval batch. Off by default,
    # as in the JAX package (cfg.tpu.int8_eval); re-validate the retrieval
    # quality per checkpoint before serving
    cfg.cuda.int8_eval = False
    # the JAX package's whole-block backward (cfg.tpu.block_megakernel): in
    # training, every stride-1 bottleneck without downsample of width <= 256
    # (layer1-3, 10 blocks per trunk) runs as bottleneck_train, whose
    # backward is the reduce3, bn3_apply, conv2_bwd and bn1_apply CUDA
    # kernels (ops/kernels/block_bwd.py). Off by default, as in the JAX
    # package, until measured times say otherwise
    cfg.cuda.block_megakernel = False
    # opt-in bf16 staging of the membership vectors for the device
    # k-reciprocal re-rank's jaccard_minsum kernel (ops/rerank_device.py),
    # summed in f32: ~1e-3 relative off the f32 oracle, as the JAX
    # package's cfg.tpu.rerank_bf16
    cfg.cuda.rerank_bf16 = False
    cfg.cuda.prefetch = 2  # host loader prefetch depth (data/loader.py)

    return cfg


def imagedata_kwargs(cfg: ConfigNode) -> dict:
    return dict(
        root=cfg.data.root,
        sources=cfg.data.sources,
        targets=cfg.data.targets,
        height=cfg.data.height,
        width=cfg.data.width,
        transforms=cfg.data.transforms,
        k_tfm=cfg.data.k_tfm,
        norm_mean=cfg.data.norm_mean,
        norm_std=cfg.data.norm_std,
        split_id=cfg.data.split_id,
        combineall=cfg.data.combineall,
        load_train_targets=cfg.data.load_train_targets,
        batch_size_train=cfg.train.batch_size,
        batch_size_test=cfg.test.batch_size,
        workers=cfg.data.workers,
        decode_cache=cfg.data.decode_cache,
        device_cache=cfg.data.device_cache,
        num_instances=cfg.sampler.num_instances,
        num_cams=cfg.sampler.num_cams,
        num_datasets=cfg.sampler.num_datasets,
        train_sampler=cfg.sampler.train_sampler,
        train_sampler_t=cfg.sampler.train_sampler_t,
        seed=cfg.train.seed,
        prefetch=cfg.cuda.prefetch,
        cuhk03_labeled=cfg.cuhk03.labeled_images,
        cuhk03_classic_split=cfg.cuhk03.classic_split,
        market1501_500k=cfg.market1501.use_500k_distractors,
    )


def optimizer_kwargs(cfg: ConfigNode) -> dict:
    return dict(
        optim=cfg.train.optim,
        lr=cfg.train.lr,
        weight_decay=cfg.train.weight_decay,
        momentum=cfg.sgd.momentum,
        sgd_dampening=cfg.sgd.dampening,
        sgd_nesterov=cfg.sgd.nesterov,
        rmsprop_alpha=cfg.rmsprop.alpha,
        adam_beta1=cfg.adam.beta1,
        adam_beta2=cfg.adam.beta2,
        staged_lr=cfg.train.staged_lr,
        new_layers=cfg.train.new_layers,
        base_lr_mult=cfg.train.base_lr_mult,
    )


def lr_scheduler_kwargs(cfg: ConfigNode) -> dict:
    return dict(
        lr_scheduler=cfg.train.lr_scheduler,
        stepsize=cfg.train.stepsize,
        gamma=cfg.train.gamma,
        max_epoch=cfg.train.max_epoch,
    )


def engine_run_kwargs(cfg: ConfigNode) -> dict:
    return dict(
        save_dir=cfg.data.save_dir,
        max_epoch=cfg.train.max_epoch,
        start_epoch=cfg.train.start_epoch,
        fixbase_epoch=cfg.train.fixbase_epoch,
        open_layers=cfg.train.open_layers,
        fixbase_bn_freeze=cfg.train.fixbase_bn_freeze,
        fixbase_bn_eval=cfg.train.fixbase_bn_eval,
        start_eval=cfg.test.start_eval,
        eval_freq=cfg.test.eval_freq,
        test_only=cfg.test.evaluate,
        print_freq=cfg.train.print_freq,
        dist_metric=cfg.test.dist_metric,
        normalize_feature=cfg.test.normalize_feature,
        visrank=cfg.test.visrank,
        visrank_topk=cfg.test.visrank_topk,
        use_metric_cuhk03=cfg.cuhk03.use_metric_cuhk03,
        ranks=cfg.test.ranks,
        rerank=cfg.test.rerank,
    )
