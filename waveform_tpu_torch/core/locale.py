"""UI string localization.

The reference ships locale tables for en-US, it-IT, zh-CN and zh-TW with
three classes of keys — property labels, enum-value labels (``line``,
``solid``, ``output_bus``, …), and ``*_desc`` tooltips — ~104 keys per
language (reference data/locale/*.ini, consumed through
``obs_module_text``).  Front-ends get the same coverage here: each
:data:`LOCALES` table is one flat dict carrying all three classes, with
tooltips stored under ``<key>_desc`` exactly like the reference's key
convention.  Strings are this project's own phrasing and translations, not
the reference's.

The port's own copy of ``waveform_tpu/core/locale.py``, identical in
behaviour: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from .properties import PROPERTY_MAP

# -- enum-value labels -------------------------------------------------------
# keys are the enum string values shared across Settings fields (one flat
# namespace, as in the reference ini files); "none" serves window, filter
# and temporal-smoothing alike, "output_bus" is the audio_source sentinel,
# "source_name" is the source-type display name.

_ENUM_EN = {
    "source_name": "Waveform (TPU)",
    "none": "None", "output_bus": "Output bus",
    "line": "Line", "solid": "Solid", "gradient": "Gradient",
    "pulse": "Pulse", "range": "Range",
    "peak_magnitude": "Peak magnitude", "peak_frequency": "Peak frequency",
    "hann": "Hann", "hamming": "Hamming", "blackman": "Blackman",
    "blackman_harris": "Blackman-Harris", "power_of_sine": "Power of sine",
    "mono": "Mono", "stereo": "Stereo", "single": "Single channel",
    "point": "Point", "lanczos": "Lanczos", "catmull_rom": "Catmull-Rom",
    "gauss": "Gaussian",
    "exp_moving_avg": "Exponential moving average",
    "tv_exp_moving_avg": "Time-varying exponential average",
    "curve": "Curve", "bars": "Bars", "stepped_bars": "Stepped bars",
    "level_meter": "Level meter",
    "stepped_level_meter": "Stepped level meter",
    "waveform": "Waveform",
}

_ENUM_ZH_CN = {
    "source_name": "波形频谱 (TPU)",
    "none": "无", "output_bus": "输出总线",
    "line": "线条", "solid": "实心", "gradient": "渐变",
    "pulse": "脉冲", "range": "区间",
    "peak_magnitude": "峰值幅度", "peak_frequency": "峰值频率",
    "hann": "汉宁窗", "hamming": "海明窗", "blackman": "布莱克曼窗",
    "blackman_harris": "布莱克曼-哈里斯窗", "power_of_sine": "正弦幂窗",
    "mono": "单声道", "stereo": "立体声", "single": "单一声道",
    "point": "点采样", "lanczos": "Lanczos", "catmull_rom": "Catmull-Rom",
    "gauss": "高斯",
    "exp_moving_avg": "指数滑动平均",
    "tv_exp_moving_avg": "时变指数平均",
    "curve": "曲线", "bars": "柱状", "stepped_bars": "阶梯柱状",
    "level_meter": "电平表", "stepped_level_meter": "阶梯电平表",
    "waveform": "波形",
}

_ENUM_ZH_TW = {
    "source_name": "波形頻譜 (TPU)",
    "none": "無", "output_bus": "輸出匯流排",
    "line": "線條", "solid": "實心", "gradient": "漸層",
    "pulse": "脈衝", "range": "區間",
    "peak_magnitude": "峰值幅度", "peak_frequency": "峰值頻率",
    "hann": "漢寧窗", "hamming": "漢明窗", "blackman": "布雷克曼窗",
    "blackman_harris": "布雷克曼-哈里斯窗", "power_of_sine": "正弦冪窗",
    "mono": "單聲道", "stereo": "立體聲", "single": "單一聲道",
    "point": "點取樣", "lanczos": "Lanczos", "catmull_rom": "Catmull-Rom",
    "gauss": "高斯",
    "exp_moving_avg": "指數移動平均",
    "tv_exp_moving_avg": "時變指數平均",
    "curve": "曲線", "bars": "長條", "stepped_bars": "階梯長條",
    "level_meter": "音量表", "stepped_level_meter": "階梯音量表",
    "waveform": "波形",
}

_ENUM_IT = {
    "source_name": "Forma d'onda (TPU)",
    "none": "Nessuno", "output_bus": "Bus di uscita",
    "line": "Linea", "solid": "Pieno", "gradient": "Gradiente",
    "pulse": "Impulso", "range": "Intervallo",
    "peak_magnitude": "Ampiezza di picco",
    "peak_frequency": "Frequenza di picco",
    "hann": "Hann", "hamming": "Hamming", "blackman": "Blackman",
    "blackman_harris": "Blackman-Harris",
    "power_of_sine": "Potenza del seno",
    "mono": "Mono", "stereo": "Stereo", "single": "Canale singolo",
    "point": "Punto", "lanczos": "Lanczos", "catmull_rom": "Catmull-Rom",
    "gauss": "Gaussiano",
    "exp_moving_avg": "Media mobile esponenziale",
    "tv_exp_moving_avg": "Media esponenziale tempo-variante",
    "curve": "Curva", "bars": "Barre", "stepped_bars": "Barre a gradini",
    "level_meter": "Indicatore di livello",
    "stepped_level_meter": "Indicatore di livello a gradini",
    "waveform": "Forma d'onda",
}

# -- tooltips ---------------------------------------------------------------
# the ~20 keys the reference attaches long descriptions to; en-US text is
# authored on the Property entries (core/properties.py), translations here.

_TIPS_ZH_CN = {
    "audio_sync_offset": "正值使画面相对音频延迟;负值依赖音频源的提前缓冲。",
    "ignore_mute": "音频源静音时仍继续分析音频。",
    "normalize_volume": "实时重新缩放图形,以抵消输入响度的变化。",
    "mirror_freq_axis": "将图形绕中心水平镜像。",
    "deadzone": "环形布局中心保留的空白区域大小。",
    "radial_arc": "环形显示的角度范围(度)。",
    "rounded_caps": "用半圆覆盖每根柱的顶端和底端。",
    "channel_mode": "分别绘制左右声道、混合为单声道,或仅选取一个采集声道。",
    "auto_fft_size": "由帧率和采样率推导 FFT 大小。仅为兼容旧场景保留——请保持关闭。",
    "enable_large_fft": "解锁 8192 以上的 FFT 大小;延迟和资源占用会明显增加。",
    "fft_size": "更大的变换能分辨更细的频率细节,但计算量和延迟更高。",
    "window": "应用于每个 FFT 帧的加权窗。",
    "temporal_smoothing": "对频率分箱做时间平均,抑制逐帧抖动。",
    "gravity": "图形跟随新输入的速度;数值越高残留越久。",
    "fast_peaks": "幅度上升时让分箱立即跳变——与较慢的滑动平均搭配效果好。",
    "interp_mode": "频率分箱重采样到显示像素的方式。",
    "filter_mode": "沿频率轴平滑曲线。",
    "slope": "将频谱向上倾斜,使高频看起来更响。",
    "rolloff_q": "从截止点向内这一数量的倍频程起开始淡出图形边缘。",
    "rolloff_rate": "边缘衰减强度,单位为分贝/倍频程。",
}

_TIPS_ZH_TW = {
    "audio_sync_offset": "正值使畫面相對音訊延遲;負值依賴音訊來源的提前緩衝。",
    "ignore_mute": "音訊來源靜音時仍繼續分析音訊。",
    "normalize_volume": "即時重新縮放圖形,以抵銷輸入響度的變化。",
    "mirror_freq_axis": "將圖形繞中心水平鏡像。",
    "deadzone": "環形佈局中心保留的空白區域大小。",
    "radial_arc": "環形顯示的角度範圍(度)。",
    "rounded_caps": "用半圓覆蓋每根長條的頂端和底端。",
    "channel_mode": "分別繪製左右聲道、混合為單聲道,或僅選取一個擷取聲道。",
    "auto_fft_size": "由影格率和取樣率推導 FFT 大小。僅為相容舊場景保留——請保持關閉。",
    "enable_large_fft": "解鎖 8192 以上的 FFT 大小;延遲和資源佔用會明顯增加。",
    "fft_size": "更大的變換能分辨更細的頻率細節,但計算量和延遲更高。",
    "window": "應用於每個 FFT 音框的加權窗。",
    "temporal_smoothing": "對頻率分箱做時間平均,抑制逐格抖動。",
    "gravity": "圖形跟隨新輸入的速度;數值越高殘留越久。",
    "fast_peaks": "幅度上升時讓分箱立即跳變——與較慢的移動平均搭配效果好。",
    "interp_mode": "頻率分箱重新取樣到顯示像素的方式。",
    "filter_mode": "沿頻率軸平滑曲線。",
    "slope": "將頻譜向上傾斜,使高頻看起來更響。",
    "rolloff_q": "從截止點向內這一數量的八度起開始淡出圖形邊緣。",
    "rolloff_rate": "邊緣衰減強度,單位為分貝/八度。",
}

_TIPS_IT = {
    "audio_sync_offset": "Valori positivi ritardano la grafica rispetto "
                         "all'audio; i valori negativi dipendono dal "
                         "buffering anticipato della sorgente.",
    "ignore_mute": "Continua ad analizzare l'audio anche quando la "
                   "sorgente è silenziata.",
    "normalize_volume": "Riscalare il grafico al volo per compensare le "
                        "variazioni di volume dell'ingresso.",
    "mirror_freq_axis": "Riflette il grafico orizzontalmente rispetto al "
                        "centro.",
    "deadzone": "Quanto spazio vuoto lasciare al centro della "
                "disposizione radiale.",
    "radial_arc": "Ampiezza angolare della visualizzazione radiale, in "
                  "gradi.",
    "rounded_caps": "Chiude le estremità di ogni barra con un "
                    "semicerchio.",
    "channel_mode": "Disegna sinistra/destra separatamente, somma in mono "
                    "o scegli un singolo canale di cattura.",
    "auto_fft_size": "Ricava la dimensione FFT dal frame rate e dalla "
                     "frequenza di campionamento. Mantenuto solo per le "
                     "vecchie scene: lasciarlo disattivato.",
    "enable_large_fft": "Sblocca dimensioni FFT oltre 8192; latenza e "
                        "consumo di risorse aumentano sensibilmente.",
    "fft_size": "Trasformate più grandi risolvono dettagli di frequenza "
                "più fini al costo di calcolo e latenza.",
    "window": "Finestra di ponderazione applicata a ogni frame FFT.",
    "temporal_smoothing": "Media i bin di frequenza nel tempo per "
                          "attenuare il tremolio tra i frame.",
    "gravity": "Quanto velocemente il grafico segue il nuovo ingresso; "
               "valori più alti persistono più a lungo.",
    "fast_peaks": "Fa saltare subito i bin quando l'ampiezza sale: si "
                  "abbina bene a una media mobile lenta.",
    "interp_mode": "Come i bin di frequenza vengono ricampionati sui "
                   "pixel di visualizzazione.",
    "filter_mode": "Leviga la curva lungo l'asse delle frequenze.",
    "slope": "Inclina lo spettro verso l'alto così le alte frequenze "
             "appaiono più forti.",
    "rolloff_q": "Sfuma i bordi del grafico a partire da questo numero di "
                 "ottave entro i punti di taglio.",
    "rolloff_rate": "Intensità dell'attenuazione ai bordi, in decibel per "
                    "ottava.",
}

# -- property labels --------------------------------------------------------

_LABELS_ZH_CN = {
    "audio_source": "音频源", "audio_sync_offset": "音频同步偏移",
    "hide_on_silent": "静音时隐藏", "ignore_mute": "忽略静音",
    "normalize_volume": "音量归一化", "volume_target": "归一化目标",
    "max_gain": "最大增益", "display_mode": "显示样式",
    "bar_width": "柱宽", "bar_gap": "柱间距", "step_width": "阶梯高度",
    "step_gap": "阶梯间距", "min_bar_height": "最小柱高",
    "width": "宽度", "height": "高度", "log_scale": "对数频率轴",
    "mirror_freq_axis": "镜像频率轴", "radial_layout": "环形布局",
    "invert_direction": "反转方向", "deadzone": "中心空区",
    "radial_arc": "弧度", "radial_rotation": "旋转", "rounded_caps": "圆角",
    "rms_mode": "RMS 电平", "meter_buf": "音频缓冲",
    "channel_mode": "声道", "channel": "声道序号",
    "channel_spacing": "声道间距", "auto_fft_size": "自动 FFT 大小",
    "enable_large_fft": "允许大 FFT", "fft_size": "FFT 大小",
    "window": "窗函数", "sine_exponent": "正弦指数",
    "temporal_smoothing": "时间平滑", "gravity": "重力",
    "fast_peaks": "快速峰值", "interp_mode": "插值",
    "filter_mode": "平滑滤波", "filter_radius": "滤波半径",
    "cutoff_low": "低频截止", "cutoff_high": "高频截止",
    "floor": "下限", "ceiling": "上限", "slope": "斜率",
    "rolloff_q": "滚降频带", "rolloff_rate": "滚降速率",
    "render_mode": "渲染样式", "pulse_mode": "脉冲跟随",
    "color_base": "基础颜色", "color_middle": "中间颜色",
    "color_crest": "峰值颜色", "grad_ratio": "渐变比例",
    "range_middle": "中间阈值", "range_crest": "峰值阈值",
}

_LABELS_ZH_TW = {
    "audio_source": "音訊來源", "audio_sync_offset": "音訊同步偏移",
    "hide_on_silent": "靜音時隱藏", "ignore_mute": "忽略靜音",
    "normalize_volume": "音量正規化", "volume_target": "正規化目標",
    "max_gain": "最大增益", "display_mode": "顯示樣式",
    "bar_width": "柱寬", "bar_gap": "柱間距", "step_width": "階梯高度",
    "step_gap": "階梯間距", "min_bar_height": "最小柱高",
    "width": "寬度", "height": "高度", "log_scale": "對數頻率軸",
    "mirror_freq_axis": "鏡像頻率軸", "radial_layout": "環形佈局",
    "invert_direction": "反轉方向", "deadzone": "中心空區",
    "radial_arc": "弧度", "radial_rotation": "旋轉", "rounded_caps": "圓角",
    "rms_mode": "RMS 電平", "meter_buf": "音訊緩衝",
    "channel_mode": "聲道", "channel": "聲道序號",
    "channel_spacing": "聲道間距", "auto_fft_size": "自動 FFT 大小",
    "enable_large_fft": "允許大 FFT", "fft_size": "FFT 大小",
    "window": "窗函數", "sine_exponent": "正弦指數",
    "temporal_smoothing": "時間平滑", "gravity": "重力",
    "fast_peaks": "快速峰值", "interp_mode": "插值",
    "filter_mode": "平滑濾波", "filter_radius": "濾波半徑",
    "cutoff_low": "低頻截止", "cutoff_high": "高頻截止",
    "floor": "下限", "ceiling": "上限", "slope": "斜率",
    "rolloff_q": "滾降頻帶", "rolloff_rate": "滾降速率",
    "render_mode": "渲染樣式", "pulse_mode": "脈衝跟隨",
    "color_base": "基礎顏色", "color_middle": "中間顏色",
    "color_crest": "峰值顏色", "grad_ratio": "漸變比例",
    "range_middle": "中間閾值", "range_crest": "峰值閾值",
}

_LABELS_IT = {
    "audio_source": "Sorgente audio", "audio_sync_offset": "Ritardo audio",
    "hide_on_silent": "Nascondi se silenzioso",
    "ignore_mute": "Ignora il muto",
    "normalize_volume": "Normalizza il volume",
    "volume_target": "Volume di riferimento", "max_gain": "Guadagno massimo",
    "display_mode": "Stile di visualizzazione", "bar_width": "Larghezza barre",
    "bar_gap": "Spaziatura barre", "step_width": "Altezza gradini",
    "step_gap": "Spaziatura gradini", "min_bar_height": "Altezza minima",
    "width": "Larghezza", "height": "Altezza",
    "log_scale": "Asse logaritmico",
    "mirror_freq_axis": "Specchia l'asse delle frequenze",
    "radial_layout": "Disposizione radiale",
    "invert_direction": "Inverti direzione", "deadzone": "Zona morta",
    "radial_arc": "Arco", "radial_rotation": "Rotazione",
    "rounded_caps": "Estremità arrotondate", "rms_mode": "Livello RMS",
    "meter_buf": "Buffer audio", "channel_mode": "Canali",
    "channel": "Indice canale", "channel_spacing": "Spaziatura canali",
    "auto_fft_size": "Dimensione FFT automatica",
    "enable_large_fft": "Consenti FFT grandi", "fft_size": "Dimensione FFT",
    "window": "Funzione finestra", "sine_exponent": "Esponente del seno",
    "temporal_smoothing": "Livellamento temporale", "gravity": "Gravità",
    "fast_peaks": "Picchi rapidi", "interp_mode": "Interpolazione",
    "filter_mode": "Filtro di livellamento", "filter_radius": "Raggio filtro",
    "cutoff_low": "Taglio basso", "cutoff_high": "Taglio alto",
    "floor": "Minimo", "ceiling": "Massimo", "slope": "Pendenza",
    "rolloff_q": "Banda di attenuazione", "rolloff_rate": "Attenuazione",
    "render_mode": "Stile di resa", "pulse_mode": "Tracciamento impulso",
    "color_base": "Colore di base", "color_middle": "Colore intermedio",
    "color_crest": "Colore di picco", "grad_ratio": "Rapporto gradiente",
    "range_middle": "Soglia intermedia", "range_crest": "Soglia di picco",
}


def _table(labels: dict, enums: dict, tips: dict) -> dict[str, str]:
    """Flatten the three key classes into one locale table (the reference's
    ini layout: labels and enum values share the namespace, tooltips ride
    ``<key>_desc``)."""
    t = dict(labels)
    t.update(enums)
    t.update({f"{k}_desc": v for k, v in tips.items()})
    return t


_EN = _table({p.key: p.label for p in PROPERTY_MAP.values()}, _ENUM_EN,
             {p.key: p.tooltip for p in PROPERTY_MAP.values() if p.tooltip})

LOCALES: dict[str, dict[str, str]] = {
    "en-US": _EN,
    "zh-CN": _table(_LABELS_ZH_CN, _ENUM_ZH_CN, _TIPS_ZH_CN),
    "zh-TW": _table(_LABELS_ZH_TW, _ENUM_ZH_TW, _TIPS_ZH_TW),
    "it-IT": _table(_LABELS_IT, _ENUM_IT, _TIPS_IT),
}


def label(key: str, locale: str = "en-US") -> str:
    """Translated property label, falling back en-US → key (the OBS
    missing-key fallback)."""
    table = LOCALES.get(locale, _EN)
    return table.get(key, _EN.get(key, key))


def enum_label(value, locale: str = "en-US") -> str:
    """Translated label for an enum value (or an enum member: its string
    value is the lookup key, matching the reference's flat namespace)."""
    v = getattr(value, "value", value)
    return label(str(v), locale)


def tooltip(key: str, locale: str = "en-US") -> str:
    """Translated tooltip for a property key ("" when the key has none)."""
    table = LOCALES.get(locale, _EN)
    return table.get(f"{key}_desc", _EN.get(f"{key}_desc", ""))
