"""NuScenes dataset helpers (host numpy), the parts the dataloader uses.

The port's copy of dataloaders/nuscenes_utils.py: transforms and
quaternion helpers, the batched rig projection, image feature sampling at
projected points (on tensors), ego-hull removal, the all-boxes
containment test, the sensor wrappers, pose helpers, the sweep walk, the
multi-sweep instance-labelled point fetch and the ego-centric map patch.
The devkit object is passed in (any object with its query surface); PIL
is imported only when an image is opened or rotated.
"""
from __future__ import annotations

import math
import os.path as osp

import numpy as np
import numpy.linalg as LA
import torch

# Detection-class canonicalization of the devkit's category names.
map_name_from_general_to_detection = {
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.wheelchair': 'ignore',
    'human.pedestrian.stroller': 'ignore',
    'human.pedestrian.personal_mobility': 'ignore',
    'human.pedestrian.police_officer': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'animal': 'ignore',
    'vehicle.car': 'car',
    'vehicle.motorcycle': 'motorcycle',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.truck': 'truck',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.emergency.ambulance': 'ignore',
    'vehicle.emergency.police': 'ignore',
    'vehicle.trailer': 'trailer',
    'movable_object.barrier': 'barrier',
    'movable_object.trafficcone': 'traffic_cone',
    'movable_object.pushable_pullable': 'ignore',
    'movable_object.debris': 'ignore',
    'static_object.bicycle_rack': 'ignore',
}

DETECTION_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus',
                     'trailer', 'motorcycle', 'bicycle', 'pedestrian')


def homo_transform(tf_mat: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N,3) points."""
    assert tf_mat.shape == (4, 4)
    return points @ tf_mat[:3, :3].T + tf_mat[:3, 3]


def quat_wxyz_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) quaternion (normalized here) -> 3x3 rotation."""
    w, x, y, z = np.asarray(q, np.float64) / LA.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def tf(translation, rotation) -> np.ndarray:
    """4x4 transform from a translation and a rotation given as an object
    with ``rotation_matrix`` (a pyquaternion Quaternion), a (3,3) matrix or
    a (w, x, y, z) sequence."""
    tf_mat = np.eye(4)
    if hasattr(rotation, 'rotation_matrix'):
        tf_mat[:3, :3] = rotation.rotation_matrix
    elif np.shape(rotation) == (3, 3):
        tf_mat[:3, :3] = rotation
    else:
        tf_mat[:3, :3] = quat_wxyz_to_matrix(rotation)
    tf_mat[:3, 3] = translation
    return tf_mat


def apply_tf(tf_mat: np.ndarray, points: np.ndarray, in_place=False):
    """Transform the xyz columns of (N,>=3) points, in place or into a new
    (N,3) array."""
    if in_place:
        points[:, :3] = homo_transform(tf_mat, points[:, :3])
        return None
    return homo_transform(tf_mat, points[:, :3])


def pts_feat_from_img(pts_uv, img, method: str = 'bilinear'):
    """Image features at (N,2) pixel coordinates [u, v] (arrays or
    tensors; every point strictly inside the image's 1-pixel border) as a
    tensor on ``img``'s device: 'nearest' gathers the rounded pixel,
    'bilinear' blends the four pixels around each point by the fractional
    parts of u and v, in the coordinates' float type. (At an integer
    coordinate the JAX copy divides 0 by 0; here the weight of the far
    pixel is 0.)"""
    if method not in ('bilinear', 'nearest'):
        raise ValueError(f"method must be 'bilinear' or 'nearest', got "
                         f'{method!r}')
    img = torch.as_tensor(img)
    uv = torch.as_tensor(pts_uv, device=img.device)
    wh = torch.tensor([img.shape[1], img.shape[0]], device=img.device)
    if not bool(((uv > 1) & (uv < wh - 1)).all()):
        raise ValueError('pts_uv must be all inside image')
    if method == 'nearest':
        px = torch.round(uv).to(torch.int64)
        return img[px[:, 1], px[:, 0]]
    base = torch.floor(uv)
    fu, fv = (uv - base).unbind(1)
    u0, v0 = base.to(torch.int64).unbind(1)
    feat = img.to(uv.dtype)
    out = torch.zeros((uv.shape[0],) + feat.shape[2:], dtype=uv.dtype,
                      device=img.device)
    for du, dv, wgt in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                        (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        w = wgt.reshape((-1,) + (1,) * (feat.dim() - 2))
        out += w * feat[v0 + dv, u0 + du]
    return out


def project_pts3d(pc_cam: np.ndarray, cam_K: np.ndarray,
                  img_wh: np.ndarray, depth_thres: float = 1e-3):
    """Camera-frame points -> (uv (N,2), in-image mask (N,)); points at
    depth <= depth_thres get uv -10."""
    mask_valid = pc_cam[:, 2] > depth_thres
    out = np.zeros((pc_cam.shape[0], 2), dtype=float) - 10
    uvw = pc_cam[mask_valid] @ cam_K.T
    out[mask_valid] = uvw[:, :2] / uvw[:, 2:3]
    mask_in_img = (out > 1) & (out < np.asarray(img_wh, float) - 1)
    return out, np.all(mask_in_img, axis=1) & mask_valid


def project_points_to_rig(points: np.ndarray, cam_from_pts: np.ndarray,
                          cam_K: np.ndarray, img_wh: np.ndarray,
                          depth_thresh: float = 1e-3):
    """Project (N,3) points onto a whole camera rig at once.

    A point inside several cameras' images goes to the highest camera
    index.

    Args:
      points: (N,3) points in a common frame.
      cam_from_pts: (C,4,4) common-frame -> camera transforms.
      cam_K: (C,3,3) intrinsics.
      img_wh: (C,2) image sizes.

    Returns (uv (N,2) in the assigned camera, 0 where none; cam_idx (N,),
    -1 where no camera sees the point)."""
    n = points.shape[0]
    local = np.einsum('cij,nj->cni', cam_from_pts[:, :3, :3],
                      points[:, :3]) + cam_from_pts[:, None, :3, 3]
    depth_ok = local[..., 2] > depth_thresh
    uvw = np.einsum('cij,cnj->cni', cam_K, local)
    w = np.where(depth_ok[..., None], uvw[..., 2:3], 1.0)
    uv_all = np.where(depth_ok[..., None], uvw[..., :2] / w, -10.0)
    wh = np.asarray(img_wh, float)[:, None, :]
    inside = depth_ok & np.all((uv_all > 1) & (uv_all < wh - 1), axis=-1)
    seen = inside.any(axis=0)
    n_cams = cam_from_pts.shape[0]
    cam_idx = np.where(seen, n_cams - 1 - inside[::-1].argmax(axis=0), -1)
    uv = np.zeros((n, 2), float)
    rows = np.flatnonzero(seen)
    uv[rows] = uv_all[cam_idx[rows], rows]
    return uv, cam_idx


def remove_ego_vehicle_points(points: np.ndarray,
                              center_radius: float) -> np.ndarray:
    """Drop points within ``center_radius`` of the sensor in xy."""
    return points[LA.norm(points[:, :2], axis=1) > center_radius]


def find_points_in_boxes(points: np.ndarray, target_from_boxes: np.ndarray,
                         dxdydz: np.ndarray, tolerance: float) -> np.ndarray:
    """(N,B) containment of (N,3+) target-frame points in B oriented boxes
    given by their box -> target transforms (B,4,4) and sizes (B,3), each
    half-size grown by ``tolerance`` of the size."""
    if target_from_boxes.shape[0] == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    inv = LA.inv(target_from_boxes)
    local = np.einsum('bij,nj->nbi', inv[:, :3, :3], points[:, :3])
    local = local + inv[None, :, :3, 3]
    return np.all(np.abs(local / dxdydz[None]) < (0.5 + tolerance), axis=2)


class NuScenesSensor:
    """A sensor's calibration and ego pose from its sample_data record."""

    def __init__(self, nusc, record):
        self.token = record['token']
        self.channel = record['channel']
        cs = nusc.get('calibrated_sensor', record['calibrated_sensor_token'])
        self.ego_from_self = tf(cs['translation'], cs['rotation'])
        ego = nusc.get('ego_pose', record['ego_pose_token'])
        self.glob_from_ego = tf(ego['translation'], ego['rotation'])
        self.glob_from_self = self.glob_from_ego @ self.ego_from_self
        self.img = None
        self.cam_K = None


class NuScenesCamera(NuScenesSensor):
    """A camera: its image (opened with PIL, imported here), size and
    intrinsics."""

    def __init__(self, nusc, record):
        from PIL import Image
        super().__init__(nusc, record)
        self.img_wh = np.array([record['width'], record['height']], float)
        self.img = Image.open(osp.join(nusc.dataroot, record['filename']))
        cs = nusc.get('calibrated_sensor', record['calibrated_sensor_token'])
        self.cam_K = np.array(cs['camera_intrinsic'])

    def project_pts3d(self, pc, depth_thres=1e-3):
        return project_pts3d(pc, self.cam_K, self.img_wh, depth_thres)


class NuScenesLidar(NuScenesSensor):
    """The lidar."""


def get_sweeps_token(nusc, curr_sd_token: str, n_sweeps: int,
                     return_time_lag: bool, return_sweep_idx: bool) -> list:
    """The sample_data token ``curr_sd_token`` and the n_sweeps - 1 lidar
    sweeps before it, oldest first. Where the chain has fewer, its oldest
    sweep repeats. With ``return_time_lag`` each entry is (token, seconds
    before ``curr_sd_token``[, sweep index = position]); otherwise the
    tokens alone."""
    chain = [curr_sd_token]
    while len(chain) < n_sweeps:
        chain.append(nusc.get('sample_data', chain[-1])['prev'] or chain[-1])
    chain.reverse()
    if not return_time_lag:
        return chain
    t_ref = nusc.get('sample_data', curr_sd_token)['timestamp'] * 1e-6
    out = []
    for position, token in enumerate(chain):
        lag = t_ref - nusc.get('sample_data', token)['timestamp'] * 1e-6
        out.append((token, lag, position) if return_sweep_idx
                   else (token, lag))
    return out


def get_nuscenes_sensor_pose_in_ego_vehicle(nusc, curr_sd_token: str):
    rec = nusc.get('sample_data', curr_sd_token)
    cs = nusc.get('calibrated_sensor', rec['calibrated_sensor_token'])
    return tf(cs['translation'], cs['rotation'])


def get_nuscenes_sensor_pose_in_global(nusc, curr_sd_token: str):
    ego_from_curr = get_nuscenes_sensor_pose_in_ego_vehicle(
        nusc, curr_sd_token)
    rec = nusc.get('sample_data', curr_sd_token)
    ego_rec = nusc.get('ego_pose', rec['ego_pose_token'])
    return tf(ego_rec['translation'], ego_rec['rotation']) @ ego_from_curr


def get_sample_data_point_cloud(nusc, sample_data_token: str,
                                time_lag: float, sweep_idx: int):
    """(N,6) float64 [x, y, z, intensity, time_lag, sweep_idx] of one
    lidar .bin file."""
    pcfile = nusc.get_sample_data_path(sample_data_token)
    pc = np.fromfile(pcfile, dtype=np.float32).reshape([-1, 5])[:, :4]
    pc = np.pad(pc, [(0, 0), (0, 2)], constant_values=0).astype(np.float64)
    pc[:, -2] = time_lag
    pc[:, -1] = sweep_idx
    return pc


def _instances_last_box(nusc, box_tfs, sizes, latest_annos,
                        target_from_glob, point_cloud_range) -> np.ndarray:
    """(I,9) [center xyz, size, yaw, velocity xy] per instance, from its
    newest box whose centre lies in the range (lower bound inclusive,
    upper bound less 1 cm, exclusive), or its oldest box when none does.
    The velocity goes through the whole target_from_glob transform,
    translation included, as the reference's output has it."""
    rng = np.asarray(point_cloud_range, np.float64)
    lo, hi = rng[:3], rng[3:] - 1e-2
    rows = []
    for tfs, size, anno in zip(box_tfs, sizes, latest_annos):
        centers = np.stack([t[:3, 3] for t in tfs])
        in_range = np.flatnonzero(np.all((centers >= lo) & (centers < hi),
                                         axis=1))
        box = tfs[in_range[-1]] if in_range.size else tfs[0]
        velo = np.asarray(nusc.box_velocity(anno)).reshape(1, 3)
        rows.append(np.concatenate([
            box[:3, 3], size, [np.arctan2(box[1, 0], box[0, 0])],
            homo_transform(target_from_glob, velo)[0, :2]]))
    return np.asarray(rows, np.float64).reshape(-1, 9)


def inst_centric_get_sweeps(nusc, sample_token: str, n_sweeps: int,
                            center_radius: float, in_box_tolerance: float,
                            return_instances_last_box: bool,
                            point_cloud_range: list,
                            detection_classes: tuple,
                            map_point_feat2idx: dict) -> dict:
    """Multi-sweep instance-labelled points of one keyframe, in its lidar
    frame. Output 'points' rows: [x, y, z, intensity, time_lag, sweep_idx,
    instance_idx, class_idx] (instance/class -1 outside every box);
    'instances_token'/'instances_center' per box occurrence; with
    ``return_instances_last_box`` also 'instances_last_box' (I,9) and
    'instances_name' (class index per instance, first-appearance order)."""
    sample_rec = nusc.get('sample', sample_token)
    target_sd_token = sample_rec['data']['LIDAR_TOP']
    sd_tokens_times = get_sweeps_token(nusc, target_sd_token, n_sweeps,
                                       return_time_lag=True,
                                       return_sweep_idx=True)
    target_from_glob = LA.inv(
        get_nuscenes_sensor_pose_in_global(nusc, target_sd_token))

    inst_token_2_index = {}
    instances, instances_size, instances_name = [], [], []
    inst_latest_anno_tk, instances_token, instances_center = [], [], []
    all_points = []
    inst_i = map_point_feat2idx['inst_idx']
    cls_i = map_point_feat2idx['cls_idx']

    for sd_token, time_lag, s_idx in sd_tokens_times:
        glob_from_cur = get_nuscenes_sensor_pose_in_global(nusc, sd_token)
        pts = get_sample_data_point_cloud(nusc, sd_token, time_lag, s_idx)
        pts = remove_ego_vehicle_points(pts, center_radius)
        pts[:, :3] = homo_transform(target_from_glob @ glob_from_cur,
                                    pts[:, :3])
        pts = np.pad(pts, [(0, 0), (0, 2)], constant_values=-1)

        kept, box_tfs, box_sizes = [], [], []
        for box in nusc.get_boxes(sd_token):
            name = map_name_from_general_to_detection[box.name]
            if name not in detection_classes:
                continue
            anno_rec = nusc.get('sample_annotation', box.token)
            if anno_rec['num_lidar_pts'] < 1:
                continue
            box_tfs.append(target_from_glob @ tf(box.center, box.orientation))
            box_sizes.append([box.wlh[1], box.wlh[0], box.wlh[2]])
            kept.append((box, anno_rec, name))
        if kept:
            contain = find_points_in_boxes(pts, np.stack(box_tfs),
                                           np.array(box_sizes),
                                           in_box_tolerance)
        for b_idx, (box, anno_rec, name) in enumerate(kept):
            mask_in = contain[:, b_idx]
            if not np.any(mask_in):
                continue
            inst_token = anno_rec['instance_token']
            if inst_token not in inst_token_2_index:
                inst_token_2_index[inst_token] = len(instances)
                instances.append([box_tfs[b_idx]])
                instances_size.append(box_sizes[b_idx])
                instances_name.append(detection_classes.index(name))
                inst_latest_anno_tk.append(anno_rec['token'])
            else:
                ci = inst_token_2_index[inst_token]
                instances[ci].append(box_tfs[b_idx])
                inst_latest_anno_tk[ci] = anno_rec['token']
            pts[mask_in, inst_i] = inst_token_2_index[inst_token]
            pts[mask_in, cls_i] = detection_classes.index(name)
            instances_token.append(inst_token)
            instances_center.append(box.center)
        all_points.append(pts)

    out = {
        'points': np.concatenate(all_points, axis=0),
        'instances_token': instances_token,
        'instances_center': instances_center,
    }
    if return_instances_last_box:
        out['instances_last_box'] = _instances_last_box(
            nusc, instances, instances_size, inst_latest_anno_tk,
            target_from_glob, point_cloud_range)
        out['instances_name'] = np.array(instances_name)
    return out


def _yaw_deg(q) -> float:
    """The heading of a (w, x, y, z) quaternion in degrees: the yaw of
    its intrinsic z-y'-x'' Tait-Bryan angles (pyquaternion's
    yaw_pitch_roll[0], which the reference reads)."""
    w, x, y, z = np.asarray(q, np.float64) / LA.norm(q)
    return math.degrees(math.atan2(2 * (w * z - x * y),
                                   1 - 2 * (y * y + z * z)))


def _square(image: np.ndarray, cx, cy, half: int) -> np.ndarray:
    """The square of half-width ``half`` pixels centred at (cx, cy)."""
    return image[int(cy - half):int(cy + half), int(cx - half):int(cx + half)]


def render_ego_centric_map(map_mask, pose: dict, axes_limit: float = 40):
    """The map patch of +-axes_limit m around the ego pose, heading up,
    as uint8 (foreground 125, background 255). ``map_mask`` is the
    devkit's MapMask (to_pixel_coords, resolution, mask(), foreground,
    background); ``pose`` an ego_pose record (translation, rotation as
    w, x, y, z). A square sqrt(2) times larger is cut first, so the
    rotation about its centre leaves no corner empty."""
    from PIL import Image
    half = int(axes_limit * (1.0 / map_mask.resolution))
    cx, cy = map_mask.to_pixel_coords(pose['translation'][0],
                                      pose['translation'][1])
    outer = _square(map_mask.mask(), cx, cy, int(half * math.sqrt(2)))
    turned = np.asarray(Image.fromarray(outer).rotate(
        90 - _yaw_deg(pose['rotation'])))
    patch = _square(turned, turned.shape[1] // 2, turned.shape[0] // 2, half)
    recolour = np.where(patch == map_mask.foreground, 125,
                        np.where(patch == map_mask.background, 255, patch))
    return recolour.astype(patch.dtype)
