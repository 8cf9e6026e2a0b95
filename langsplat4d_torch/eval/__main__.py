"""Open-vocabulary query evaluation CLI, `python -m langsplat4d_torch.eval`
(port of the root eval.py; reference eval/eval.py:405-791).

Reads rendered `.npy` language-feature maps (levels 1-3 in sam mode, level 0
in video mode), decodes every level of a frame at once through the language
autoencoder on the device, scores the prompts' relevancy and reports the
mean IoU (and vIoU / accuracy for time-sensitive queries): the same flags,
env knobs, feature layout, `Mean IoU: <x>` line and CSVs as the JAX CLI.
Text embeddings come from a precomputed .npz cache (--text_embedding_cache)
or from CLIP's text tower in a local directory (--clip_model_path).
Runs on the GPU unless `--device cpu`.
"""
import argparse
import csv
import glob
import json
import logging
import os
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from langsplat4d_torch.ae import model as AE
from langsplat4d_torch.core.device import fp32_matmul, resolve_device
from langsplat4d_torch.core.transforms import safe_normalize
from langsplat4d_torch.eval import evaluate as E
from langsplat4d_torch.eval.relevancy import make_text_embedder

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluation script parameters")
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("--iterations", type=int, required=True)
    p.add_argument("--prompts", nargs="+", type=str, default=None)
    p.add_argument("--output_path", type=str, default="eval_result")
    p.add_argument("--annotation_folder", type=str, required=True)
    p.add_argument("--langfeat_mode", choices=["sam", "video"], default="sam")
    p.add_argument("--dataset_type", choices=["hypernerf", "neu3d"],
                   default="hypernerf")
    p.add_argument("--ae_ckpt_path", type=str, required=True)
    p.add_argument("--video_ae_ckpt_path", type=str, default=None)
    p.add_argument("--use_gt_feat", type=int, default=0)
    p.add_argument("--mask_tresh", type=float, default=0.4)
    p.add_argument("--scale", type=int, default=29)
    p.add_argument("--chose_mask_strategy", choices=["point", "mean"],
                   default="point")
    p.add_argument("--tag", type=str, default="default")
    p.add_argument("--feat_dim", type=int, default=3)
    p.add_argument("--video_feat_dim", type=int, default=6)
    p.add_argument("--video_feat_dir", type=str, default=None)
    p.add_argument("--apply_video_search", action="store_true")
    p.add_argument("--video_encoder_hidden_dims", nargs="+", type=int,
                   default=[2048, 1024, 512, 256, 128, 64, 32, 6])
    p.add_argument("--video_decoder_hidden_dims", nargs="+", type=int,
                   default=[32, 64, 128, 256, 512, 1024, 2048, 4096])
    p.add_argument("--encoder_hidden_dims", nargs="+", type=int,
                   default=[256, 128, 64, 32, 3])
    p.add_argument("--decoder_hidden_dims", nargs="+", type=int,
                   default=[16, 32, 64, 128, 256, 512])
    p.add_argument("--video_frame_gt_path", type=str, default=None)
    p.add_argument("--video_eval_iterations", default=20000, type=int)
    p.add_argument("--smooth_feature_post", action="store_true")
    p.add_argument("--smooth_feature_post_frames", default=1, type=int)
    p.add_argument("--smooth_feature_post_coff", nargs="+", type=float,
                   default=None)
    p.add_argument("--detail_results", action="store_true")
    p.add_argument("--visualize_results", action="store_true",
                   help="write per-prompt heatmap/composited/background/"
                        "annotation images + chosen masks (eval/eval.py:"
                        "178-224,300-307); the frames must be PNG")
    p.add_argument("--adaptive_thresh", action="store_true")
    p.add_argument("--adaptive_alpha", type=float, default=None)
    p.add_argument("--low_thresh_filter", type=int, default=None)
    p.add_argument("--text_embedding_cache", type=str, default=None,
                   help=".npz of prompt->CLIP text embedding (+negatives)")
    p.add_argument("--clip_model_path", type=str, default=None,
                   help="a local copy of the CLIP model whose text tower "
                        "encodes the prompts where no cache is given")
    p.add_argument("--feat_root", type=str, default=None,
                   help="override the rendered-feature root directory")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the current CUDA device by default")
    return p.parse_args(argv)


def decode_levels(model, sem: torch.Tensor) -> torch.Tensor:
    """[L, H, W, d] rendered features -> [L, H, W, D]: every level through
    the decoder at once, undoing the render's (x + 1) / 2 first where every
    value is positive (eval/eval.py: the reference's scale-back)."""
    sem = torch.where(sem.min() > 0, sem * 2.0 - 1, sem)
    lvl, h, w, d = sem.shape
    with fp32_matmul():
        return model.decode(sem.reshape(-1, d)).reshape(lvl, h, w, -1)


def read_frame(path: str):
    """The annotated frame as [H, W, 3] float RGB for the composites, or
    None where there is no file (the reference's cv2.imread gives None).
    PNG or baseline JPEG through the port's codec; a grey frame is spread
    over the three channels, as cv2.imread's colour mode does."""
    if not os.path.exists(path):
        return None
    from langsplat4d_torch.data.codec import read_image
    img = read_image(path)
    if img.shape[2] < 3:
        img = img[..., :1].repeat(3, 2)
    return (img[..., :3] / 255.0).astype(np.float32)


def main(argv=None):
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format="%(asctime)s | %(levelname)s | "
                                   "%(message)s")
    args = parse_args(argv)
    device = resolve_device(args.device)
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    output_path = os.path.join(args.output_path, args.exp_name,
                               f"{timestamp}-{args.tag}")
    os.makedirs(output_path, exist_ok=True)

    npy_file_name = "gt_npy" if args.use_gt_feat else "renders_npy"
    split_name = "video_lang" if args.dataset_type == "hypernerf" \
        else "test_lang"
    root = args.feat_root or os.path.join(os.getenv("ExpsDir", "../output"),
                                          args.dataset_type)
    levels = [1, 2, 3] if args.langfeat_mode == "sam" else [0]
    feat_dir = [os.path.join(root, f"{args.exp_name}_{level}",
                             f"{split_name}/ours_{args.iterations}/"
                             f"{npy_file_name}") for level in levels]

    # video-feature maps (level 0) for time-sensitive queries
    video_features = []
    if args.apply_video_search:
        assert args.video_feat_dir is not None
        vdir = os.path.join(root, f"{args.video_feat_dir}_0",
                            f"{split_name}/ours_{args.video_eval_iterations}/"
                            f"{npy_file_name}")
        for name in sorted(os.listdir(vdir)):
            video_features.append(np.load(os.path.join(vdir, name)))
        if args.video_frame_gt_path is None:
            args.video_frame_gt_path = os.path.join(
                args.annotation_folder, "video_annotations.json")

    smooth_coff = args.smooth_feature_post_coff
    if args.apply_video_search and smooth_coff is None:
        smooth_coff = ([0.1, 0.8, 0.1] if args.smooth_feature_post_frames == 1
                       else [0.1, 0.2, 0.4, 0.2, 0.1])

    replace_prompts = {}
    prompts_for_video = []
    gt_frame_dict = {}
    if args.apply_video_search:
        with open(args.video_frame_gt_path) as f:
            gt_frame_dict = json.load(f)
        for key in gt_frame_dict:
            replace_prompts[key] = list(gt_frame_dict[key].keys())
            prompts_for_video.extend(gt_frame_dict[key].keys())

    # the reference's env knobs (eval/eval.py:226-239,540-542,613); the
    # flags win
    adaptive_on = args.adaptive_thresh or os.getenv("adaptive_thresh",
                                                    "f") == "t"
    adaptive_alpha = args.adaptive_alpha
    if adaptive_alpha is None and os.getenv("adaptive_alpha"):
        adaptive_alpha = float(os.environ["adaptive_alpha"])
    low_filter = args.low_thresh_filter
    if low_filter is None:
        low_filter = int(os.getenv("low_thresh_filter", 0))
    # smooth_video_feature_pre: uniform temporal smoothing of the per-frame
    # video-feature similarity over +-video_smooth_frames (the JAX package's
    # reading of the reference's unused neighbour-frame list, :540-545)
    pre_smooth_frames = 0
    if os.getenv("smooth_video_feature_pre", "f") == "t":
        pre_smooth_frames = int(os.getenv("video_smooth_frames", 2))

    json_folder = os.path.join(args.annotation_folder, "train")
    gt_ann, image_shape, image_paths, id2name, name2id, im_id2imidx = \
        E.load_coco_annotations(json_folder, args.prompts, replace_prompts,
                                args.dataset_type,
                                visualize_results=args.visualize_results,
                                vis_output_path=output_path)
    eval_index_list = [int(i) for i in gt_ann.keys()]

    # the rendered feature maps, [levels, frames, H, W, d] on the host
    sem_feats = np.zeros((len(feat_dir), len(eval_index_list), *image_shape,
                          args.feat_dim), np.float32)
    for i, d in enumerate(feat_dir):
        paths = sorted(glob.glob(os.path.join(d, "*.npy")), key=lambda fn:
                       int(os.path.basename(fn).split(".npy")[0]))
        for j, idx in enumerate(eval_index_list):
            sem_feats[i][j] = np.load(paths[im_id2imidx[idx]])

    embedder = make_text_embedder(args.text_embedding_cache,
                                  args.clip_model_path, device=device)
    neg_embeds = embedder.negatives()

    # use_vae checkpoints load as VanillaVAE (load_ckpt sniffs fc_mu)
    ae = AE.load_ckpt(args.ae_ckpt_path, args.encoder_hidden_dims,
                      args.decoder_hidden_dims, device=device)
    video_decode = None
    name2query_embed = {}
    if args.apply_video_search:
        vae = AE.load_ckpt(args.video_ae_ckpt_path,
                           args.video_encoder_hidden_dims,
                           args.video_decoder_hidden_dims, 4096,
                           device=device)
        # the JAX CLI decodes video features with the plain AE decode
        # whatever the checkpoint (eval.py: AE.decode(vae_params, x))
        video_decode = lambda x: plain_decode(vae, x)  # noqa: E731
        for key, values in replace_prompts.items():
            for prompt_name in values:
                name2query_embed[prompt_name] = embedder.encode(
                    [prompt_name])[0]

    chosen_iou_all, chosen_lvl_all = [], []
    prompt_iou_all = defaultdict(list)
    interval_eval = os.getenv("interval", None)
    with torch.no_grad():
        for j, idx in enumerate(eval_index_list):
            if interval_eval is not None and j % int(interval_eval) != 0:
                continue
            img_ann = gt_ann[f"{idx}"]
            prompts = list(img_ann.keys())
            if not prompts:
                continue
            sem = torch.from_numpy(sem_feats[:, j]).to(device)
            restored = decode_levels(ae, sem)
            pos_embeds = embedder.encode(prompts)
            gt_masks = {k: img_ann[k]["mask"] for k in prompts}
            image_name = os.path.join(output_path, f"{idx + 1:0>5}")
            rgb_img = None
            if args.visualize_results:
                os.makedirs(image_name, exist_ok=True)
                rgb_img = read_frame(image_paths[j])
            c_iou, c_lvl, per_prompt, mask_dict, mask_video_dict = \
                E.activate_stream(restored, prompts, pos_embeds, neg_embeds,
                                  gt_masks, thresh=args.mask_tresh,
                                  scale=args.scale,
                                  chose_mask_strategy=args.chose_mask_strategy,
                                  adaptive_thresh=adaptive_on,
                                  adaptive_alpha=adaptive_alpha,
                                  low_thresh_filter=low_filter,
                                  image=rgb_img, image_name=image_name,
                                  visualize_results=args.visualize_results)
            del restored
            for key, (iou, lvl_c, lvl_all, thr_all) in per_prompt.items():
                sim = 0.0
                if args.apply_video_search and key in prompts_for_video:
                    vfeat = video_features[im_id2imidx[idx]]
                    sim = E.cal_avg_video_feature(
                        video_decode, mask_video_dict[key][0], vfeat,
                        name2query_embed[key])
                prompt_iou_all[key].append((idx, iou, lvl_c, lvl_all,
                                            thr_all, sim))
            chosen_iou_all.extend(c_iou)
            chosen_lvl_all.extend(c_lvl)

    result_data = []
    for key, rows in prompt_iou_all.items():
        if key in prompts_for_video:
            continue
        mean_iou_key = sum(fm[1] for fm in rows) / len(rows)
        # reference row layout (eval/eval.py:666-689): prompt, mean IoU,
        # chosen levels, per-level similarity, per-level thresh, video sims,
        # then one IoU column per annotated frame
        row = [key, mean_iou_key,
               [fm[2] for fm in rows],
               [list(np.asarray(fm[3], dtype=float)) for fm in rows],
               [fm[4] for fm in rows],
               [fm[5] for fm in rows]]
        by_idx = {fm[0]: fm[1] for fm in rows}
        for idx in eval_index_list:
            row.append(by_idx.get(idx, "NA"))
        result_data.append(row)
        logger.info(f"key:{key}, mean_iou:{mean_iou_key}")
    mean_iou = None
    if result_data:
        mean_iou = sum(fm[1] for fm in result_data) / len(result_data)
        logger.info(f"Mean IoU: {mean_iou}")
        print(f"Mean IoU: {mean_iou}")

    if args.detail_results and result_data:
        with open(os.path.join(output_path, "time-agnostic_results.csv"),
                  "w", newline="") as f:
            writer = csv.writer(f)
            header = ["Prompt", "Mean IoU", "Lvls", "Similarity", "Tresh",
                      "Video feature Similarity"]
            header += [f"frame_{i + 1}_iou" for i in eval_index_list]
            writer.writerow(header)
            writer.writerows(result_data)

    if args.apply_video_search:
        video_search(args, prompts_for_video, prompt_iou_all, im_id2imidx,
                     gt_frame_dict, pre_smooth_frames, smooth_coff,
                     output_path)
    return mean_iou


def plain_decode(model, x: torch.Tensor) -> torch.Tensor:
    """The AE decode (ReLU between the decoder's Linears, L2-normalised
    output) applied to any checkpoint's decoder, as the JAX CLI applies
    `AE.decode` to the video checkpoint."""
    with fp32_matmul():
        for i, m in enumerate(model.decoder):
            if isinstance(m, torch.nn.Linear):
                if i > 0:
                    x = torch.relu(x)
                x = m(x)
    return safe_normalize(x)


def video_search(args, prompts_for_video, prompt_iou_all, im_id2imidx,
                 gt_frame_dict, pre_smooth_frames, smooth_coff, output_path):
    """Time-sensitive queries: per prompt, the frames' similarity lists
    thresholded at their mean, vIoU and accuracy (eval/eval.py:282-363)."""
    video_res_list, clip_res_list = [], []
    for key in prompts_for_video:
        rows = prompt_iou_all.get(key, [])
        if not rows:
            continue
        video_sim = sorted(
            [(im_id2imidx[fm[0]], fm[5], fm[1]) for fm in rows])
        clip_sim = sorted(
            [(im_id2imidx[fm[0]], fm[3][fm[2]], fm[1]) for fm in rows])
        if pre_smooth_frames > 0:
            uni = [1.0 / (2 * pre_smooth_frames + 1)] * \
                (2 * pre_smooth_frames + 1)
            video_sim = E.smooth_similarity(video_sim, pre_smooth_frames, uni)
        if args.smooth_feature_post:
            video_sim = E.smooth_similarity(
                video_sim, args.smooth_feature_post_frames, smooth_coff)
            clip_sim = E.smooth_similarity(
                clip_sim, args.smooth_feature_post_frames, smooth_coff)
        video_thresh = sum(t[1] for t in video_sim) / len(video_sim)
        clip_thresh = sum(t[1] for t in clip_sim) / len(clip_sim)
        E.save_similarity_plot(
            video_sim, os.path.join(output_path, f"{key}_video_feat_sim.png"),
            thresh_hold=video_thresh)
        E.save_similarity_plot(
            clip_sim, os.path.join(output_path, f"{key}_clip_feat_sim.png"),
            thresh_hold=clip_thresh)
        for base_key, video_prompts in gt_frame_dict.items():
            if key in video_prompts:
                vres = E.evaluate_video_feature(video_sim, video_prompts[key],
                                                video_thresh)
                cres = E.evaluate_video_feature(clip_sim, video_prompts[key],
                                                clip_thresh)
                logger.info(
                    f"Key: {key}. Video Feature: "
                    f"vIoU:{vres['average_iou']}, "
                    f"Accuracy:{vres['accuracy']}. Clip Feature: "
                    f"vIoU:{cres['average_iou']}, "
                    f"Accuracy:{cres['accuracy']}")
                video_res_list.append((vres["average_iou"],
                                       vres["accuracy"]))
                clip_res_list.append((cres["average_iou"],
                                      cres["accuracy"]))
                if args.detail_results:
                    E.plot_confusion_matrix(
                        vres["label_list"], vres["predict_list"],
                        [False, True], f"video-{key}", output_path)
                    E.plot_confusion_matrix(
                        cres["label_list"], cres["predict_list"],
                        [False, True], f"clip-{key}", output_path)
        if args.detail_results:
            with open(os.path.join(output_path,
                                   f"video-query-results-{key}.csv"),
                      "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(
                    ["Type"] + [f"frame_{fm[0]}_iou" for fm in clip_sim])
                writer.writerow(["clip similarity"]
                                + [fm[1] for fm in clip_sim])
                writer.writerow(["clip meaniou"]
                                + [fm[2] for fm in clip_sim])
                writer.writerow(["video similarity"]
                                + [fm[1] for fm in video_sim])
                writer.writerow(["video meaniou"]
                                + [fm[2] for fm in video_sim])
    if video_res_list:
        logger.info(
            f"Video: Average vIoU: "
            f"{sum(f[0] for f in video_res_list) / len(video_res_list)}, "
            f"Average Accuracy: "
            f"{sum(f[1] for f in video_res_list) / len(video_res_list)}")
        logger.info(
            f"Clip: Average vIoU: "
            f"{sum(f[0] for f in clip_res_list) / len(clip_res_list)}, "
            f"Average Accuracy: "
            f"{sum(f[1] for f in clip_res_list) / len(clip_res_list)}")


if __name__ == "__main__":
    main(sys.argv[1:])
